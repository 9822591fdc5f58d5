// Flash-attention forward over the fused qkv projection, every head of a
// query tile in one CTA, for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel tools/exp_flash.py::_batched_kernel,
// which computes the forward of flash_attention_qkv.cu as ONE batched product
// over a stacked [H, N, hd] view of each batch element (the question it asks:
// do the heads' matrix products run back to back when one program is handed
// all of them at once?).  Same arithmetic as the plain version: S = q.k^T /
// sqrt(hd) in fp32 plus the optional [B, N] key mask, the exact fp32 row
// softmax, P rounded to bf16 after the normalisation, V read as bf16, P.V
// accumulated in fp32, ctx in bf16.  Takes N = 1 .. 256 and any H (D =
// 64*H).
//
// What bounds it on an H100 (wgmma_attention.cuh): bytes, 8*B*N*D (0.0925 ms
// at B=256 H=12 N=197, 0.0625 ms at N=133), against 0.031 ms of tensor-core
// work; on the card neither is reached: the chain of each item at three
// warpgroups a SM holds it (~0.26 ms at N=197, PERF.md).
//
// The schedule.  On the TPU one grid step holds a whole batch element and
// issues every head's product in one op.  Here one CTA per (batch, 64 query
// rows) walks all H heads with three consumer warpgroups (12 attending warps
// a SM, one CTA a SM: 3 rings of 72 KB): warpgroup w takes heads w, w+3, ...
// and runs free of the others -- each has its own TMA ring and mbarriers,
// and the three meet only once, before the first load -- so the products of
// one warpgroup run while another takes its softmax and a third waits for
// its loads, with no order imposed between them.  Each head is one item of
// the shared core (wgmma_attention.cuh: S on wgmma from TMA boxes, the
// softmax in registers, P.V on wgmma with P from registers), and its context
// leaves straight from registers into its 64 columns of [B, N, D].
//
// Registers: one row of S (104 fp32 at N=197, 128 at N=256) at three
// warpgroups a SM, so ptxas is capped at 168 (its counts are in PERF.md).
// Left on the table: see wgmma_attention.cuh; and 1024 CTAs at B=256 N=197
// are 7.8 waves of 132 SMs (a persistent grid was slower on the card).

#include "wgmma_attention.cuh"

namespace {

using namespace clibd;
using namespace clibd::wgattn;

constexpr int W = 3;  // consumer warpgroups

template <int KT>
__global__ void __launch_bounds__(W * 128, 1)
batched_bf16_kernel(const __grid_constant__ CUtensorMap qkv_map, const float* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, int N, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_layout<W>(smem_raw);
  const int qtiles = (N + QROWS - 1) / QROWS;
  const int b = blockIdx.x / qtiles, q0 = (blockIdx.x % qtiles) * QROWS;
  const int wg = threadIdx.x / 128;
  setup(sm, mask, b, N);
  const int heads = wg < H ? (H - 1 - wg) / W + 1 : 0;
  const ItemLoop<FusedQkv> L{{&qkv_map, out, b, N, H * HD}, sm.rings + wg * RING,
                             sm.bars + wg * SLOTS, sm.key_row, q0, wg, W, heads, scale};
  NoTurns turns;
  attend_items<KT>(L, turns);
}

template <int KT>
cudaError_t launch(const CUtensorMap& map, const float* mask, void* out, int N, int H, int grid,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes(W);
  const cudaError_t e = cudaFuncSetAttribute(batched_bf16_kernel<KT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  batched_bf16_kernel<KT><<<grid, W * 128, smem, stream>>>(
      map, mask, static_cast<__nv_bfloat16*>(out), N, H, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch at (N, H) needs, 0 where the kernel does not take
// the shapes (N outside 1 .. 256).
long clibd_flash_batched_smem_bytes(int N, int H) {
  if (N < 1 || N > MAX_N || H < 1) return 0;
  return smem_bytes(W);
}

// qkv [B, N, 3*H*64] bf16 contiguous, 16-byte aligned; mask [B, N] fp32 or
// null; out [B, N, H*64] bf16.  Launches on `stream` and returns the launch's
// error (0 = launched): shapes it does not take, a tensor map that does not
// encode, too much shared memory.
int clibd_flash_attention_qkv_batched(const void* qkv, const float* mask, void* out, int B, int N,
                                      int H, void* stream) {
  const size_t smem = (size_t)clibd_flash_batched_smem_bytes(N, H);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long grid = (long)B * ((N + QROWS - 1) / QROWS);
  if (B < 1 || smem == 0 || smem > (size_t)max_smem || (long)B * N > 0x7fffffffL ||
      grid > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t e = encode_bf16_sw128(&map, qkv, N, 3 * H * HD, 64, B);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kt_instance(N)) {
    case 2: return (int)launch<2>(map, mask, out, N, H, (int)grid, s);
    case 4: return (int)launch<4>(map, mask, out, N, H, (int)grid, s);
    case 9: return (int)launch<9>(map, mask, out, N, H, (int)grid, s);
    case 13: return (int)launch<13>(map, mask, out, N, H, (int)grid, s);
    default: return (int)launch<16>(map, mask, out, N, H, (int)grid, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
