// Flash-attention forward over the fused qkv projection, phased across a
// group of heads, for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel tools/exp_flash.py::_phased_kernel,
// which computes the forward of flash_attention_qkv.cu with the per-head
// chain reordered: for a batch element, every head's q.k^T first, then every
// softmax, then every P.V (the question it asks: do the matrix units stay
// busy when the softmaxes no longer sit between dependent products?).  Same
// arithmetic as the plain version: S = q.k^T / sqrt(hd) in fp32 plus the
// optional [B, N] key mask, the exact fp32 row softmax, P rounded to bf16
// after the normalisation, V read as bf16, P.V accumulated in fp32.  Takes
// N = 1 .. 256 and every head group G of 1, 2, 3, 4, 6, 8, 12 that divides H.
//
// What bounds it on an H100 (wgmma_attention.cuh): bytes, 8*B*N*D (0.0925 ms
// at B=256 H=12 N=197, 0.0625 ms at N=133), against 0.031 ms of tensor-core
// work; on the card neither is reached: the chain of each item at three
// warpgroups a SM holds it (~0.25 ms at N=197 with G=12, PERF.md).
//
// The schedule.  On the TPU the three phases are statement order inside one
// grid step.  On Hopper a product is asynchronous, and what "the products of
// the group issued before the softmaxes that would sit between them" can
// mean is that one warpgroup's wgmma is in flight while another runs its
// softmax.  One CTA per (batch, group of G heads, 64 query rows) runs W
// consumer warpgroups (W = 1, 2, 3, 2, 3, 2, 3 for G = 1, 2, 3, 4, 6, 8, 12;
// at most three a SM, for their registers and rings), warpgroup w taking
// heads w, w+W, ... of the group, each head one item of the shared core
// (wgmma_attention.cuh).  The warpgroups issue their products in turns
// (Turns, a ring of named barriers): w's S, then w+1's S, ..., then w's P.V,
// w+1's P.V, ..., so while one warpgroup's products run on the tensor cores
// the one before it takes its softmax -- the phases, ping-ponged.  G keeps
// its meaning: the heads a CTA takes through its phases.  Each warpgroup
// waits for its own loads before it asks for its turn, so no turn is held
// over a copy.  Every G fits (the core holds one row of S in registers, not
// G tiles of S in shared memory), so None in the wrapper takes G = H.
//
// Occupancy: W = 3 is one CTA of 12 warps a SM, W = 2 one of 8 (two would
// not fit the rings), W = 1 three CTAs of 4; so on the card G = 1, 6 and 12
// are the fastest and G = 2, 4 (8 warps a SM) the slowest.  Registers: one
// row of S (104 fp32 at N=197, 128 at N=256); ptxas is capped at 168 for
// W = 1 and 3 (its counts are in PERF.md).  Left on the table: see
// wgmma_attention.cuh; the strict order of turns makes a warpgroup that is
// ready wait for the one before it.

#include "wgmma_attention.cuh"

namespace {

using namespace clibd;
using namespace clibd::wgattn;

// consumer warpgroups of a CTA with G heads
__host__ __device__ constexpr int warpgroups(int G) {
  return G <= 3 ? G : G % 3 == 0 ? 3 : 2;
}

template <int W, int KT>
__global__ void __launch_bounds__(W * 128, W == 1 ? 3 : 1)
phased_bf16_kernel(const __grid_constant__ CUtensorMap qkv_map, const float* __restrict__ mask,
                   __nv_bfloat16* __restrict__ out, int N, int H, int G, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_layout<W>(smem_raw);
  // consecutive CTAs are the query tiles of one (batch, head group), so they
  // find its K and V in L2
  const int qtiles = (N + QROWS - 1) / QROWS, groups = H / G;
  const int b = blockIdx.x / (groups * qtiles);
  const int h0 = (blockIdx.x / qtiles % groups) * G;
  const int q0 = (blockIdx.x % qtiles) * QROWS;
  const int wg = threadIdx.x / 128;
  setup(sm, mask, b, N);
  const int heads = G / W;  // W divides G
  const ItemLoop<FusedQkv> L{{&qkv_map, out, b, N, H * HD}, sm.rings + wg * RING,
                             sm.bars + wg * SLOTS, sm.key_row, q0, h0 + wg, W, heads, scale};
  Turns turns{wg, W, 0, 2 * heads - 1};
  turns.begin();
  attend_items<KT>(L, turns);
}

template <int W, int KT>
cudaError_t launch(const CUtensorMap& map, const float* mask, void* out, int B, int N, int H,
                   int G, cudaStream_t stream) {
  constexpr int smem = smem_bytes(W);
  cudaError_t e = cudaFuncSetAttribute(phased_bf16_kernel<W, KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long grid = (long)B * (H / G) * ((N + QROWS - 1) / QROWS);
  if (grid > 0x7fffffffL) return cudaErrorInvalidValue;
  phased_bf16_kernel<W, KT><<<(int)grid, W * 128, smem, stream>>>(
      map, mask, static_cast<__nv_bfloat16*>(out), N, H, G, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_kt(const CUtensorMap& map, const float* mask, void* out, int B, int N, int H,
                      int G, cudaStream_t stream) {
  switch (kt_instance(N)) {
    case 2: return launch<W, 2>(map, mask, out, B, N, H, G, stream);
    case 4: return launch<W, 4>(map, mask, out, B, N, H, G, stream);
    case 9: return launch<W, 9>(map, mask, out, B, N, H, G, stream);
    case 13: return launch<W, 13>(map, mask, out, B, N, H, G, stream);
    default: return launch<W, 16>(map, mask, out, B, N, H, G, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory a launch at (N, H, G) needs, 0 where the kernel does not take
// the shapes: N outside 1 .. 256, or G not one of 1, 2, 3, 4, 6, 8, 12
// dividing H.
long clibd_flash_phased_smem_bytes(int N, int H, int G) {
  const bool taken = G == 1 || G == 2 || G == 3 || G == 4 || G == 6 || G == 8 || G == 12;
  if (N < 1 || N > MAX_N || H < 1 || !taken || H % G) return 0;
  return smem_bytes(warpgroups(G));
}

// qkv [B, N, 3*H*64] bf16 contiguous, 16-byte aligned; mask [B, N] fp32 or
// null; out [B, N, H*64] bf16; G heads per CTA.  Launches on `stream` and
// returns the launch's error (0 = launched): shapes it does not take, a
// tensor map that does not encode, too much shared memory.
int clibd_flash_attention_qkv_phased(const void* qkv, const float* mask, void* out, int B, int N,
                                     int H, int G, void* stream) {
  const size_t smem = (size_t)clibd_flash_phased_smem_bytes(N, H, G);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (B < 1 || smem == 0 || smem > (size_t)max_smem || (long)B * N > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t e = encode_bf16_sw128(&map, qkv, N, 3 * H * HD, 64, B);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (warpgroups(G)) {
    case 1: return (int)launch_kt<1>(map, mask, out, B, N, H, G, s);
    case 2: return (int)launch_kt<2>(map, mask, out, B, N, H, G, s);
    default: return (int)launch_kt<3>(map, mask, out, B, N, H, G, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
