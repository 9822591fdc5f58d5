// Flash-attention forward over the fused qkv projection, every head of a
// query tile in one CTA, for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel tools/exp_flash.py::_batched_kernel,
// which computes the forward of flash_attention_qkv.cu as ONE batched product
// over a stacked [H, N, hd] view of each batch element (the question it asks:
// does the compiler schedule the heads' matrix products back to back when it
// is handed all of them at once?).  Same arithmetic as the forward kernel:
// S = q.k^T / sqrt(hd) in fp32 plus the optional [B, N] key mask, the exact
// fp32 row softmax, P rounded to bf16 after the normalisation, V read as
// bf16, P.V accumulated in fp32, ctx in bf16.
//
// The schedule.  On the TPU one grid step holds the whole [N, 3D] slab of a
// batch element in VMEM and issues every head's product in one op.  A CTA
// here has 227 KB of shared memory, not a slab of 0.9 MB, and its warps are
// the unit that overlaps: the counterpart is one CTA per (batch, 64 query
// rows) that walks ALL H heads as one loop, with head h+1's K and V copied
// by cp.async into a second buffer while the four warps (16 query rows
// each) attend over head h -- so the copies of one head overlap the products
// and softmax of the previous one, which is what batching the heads buys.
// Each warp keeps its 16-row chain in registers (attend_rows_bf16, as the
// forward kernel), writes its bf16 context into the CTA's [64, D] tile, and
// the tile leaves as whole rows (16-byte stores, D*2 contiguous bytes per
// row).  The head loop is flash_common.cuh's attend_heads_to_ctx, shared
// with flash_attention_qkv_outproj.cu (one stage of a head pair there).
//
// Shared memory at N=197 (208 keys), D=768: the context tile 64 x 776 bf16
// (99,328 B) plus two buffers of one head's K and V at row stride 72
// (2 x 59,904 B): 219,136 B, one CTA (4 warps) per SM.  Registers: the
// 16 x 208 fp32 score block of attend_rows_bf16 (104) plus q fragments and
// the 16 x 64 output accumulator; ptxas' count is in PERF.md.
//
// Left on the table: 4 warps per SM is little to hide latency with (the
// context tile and the two stages take the whole SM); wgmma and TMA;
// K and V of a head re-read from L2 by every query tile (4 per element at
// N=197); N above ~215 at D=768 does not fit (the wrapper refuses it).

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QROWS = 64;
constexpr int STAGES = 2;

// shared memory of a launch with npad keys and D = 64*H
size_t smem_bytes(int npad, int H) {
  return ctx_tile_bytes(H * HD) + STAGES * kv_rows_bytes(npad);
}

template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
batched_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * HD;
  const int CS = D + 8;
  __nv_bfloat16* ctx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* kv = smem_raw + ctx_tile_bytes(D);

  const int qtiles = (N + QROWS - 1) / QROWS;
  const int b = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * QROWS;
  const int rows = min(QROWS, N - q0);
  const long rs = 3L * D;
  const __nv_bfloat16* base = qkv + (long)b * N * rs;
  const float* mrow = mask ? mask + (long)b * N : nullptr;

  attend_heads_to_ctx<KT, 1, STAGES>(ctx, kv, base, rs, mrow, N, H, q0, rows, scale);

  __nv_bfloat16* orow = out + ((long)b * N + q0) * D;
  for (int idx = threadIdx.x; idx < rows * (D / 8); idx += THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(orow + (long)r * D + c) =
        *reinterpret_cast<const uint4*>(ctx + r * CS + c);
  }
}

template <int KT>
cudaError_t launch(const void* qkv, const float* mask, void* out, int B, int N, int H,
                   size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(batched_bf16_kernel<KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long grid = (long)B * ((N + QROWS - 1) / QROWS);
  batched_bf16_kernel<KT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<__nv_bfloat16*>(out), N, H,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch at (N, H) needs, 0 where the kernel does not take
// the shapes.
long clibd_flash_batched_smem_bytes(int N, int H) {
  if (N < 1 || N > MAX_N || H < 1) return 0;
  return (long)smem_bytes(kt_instance(N) * 16, H);
}

// qkv [B, N, 3*H*64] bf16 contiguous; mask [B, N] fp32 or null; out
// [B, N, H*64] bf16.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched); cudaErrorInvalidValue for shapes it does not take.
int clibd_flash_attention_qkv_batched(const void* qkv, const float* mask, void* out, int B, int N,
                                      int H, void* stream) {
  const size_t smem = (size_t)clibd_flash_batched_smem_bytes(N, H);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (B < 1 || smem == 0 || smem > (size_t)max_smem || (long)B * N > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kt_instance(N)) {
    case 2: return (int)launch<2>(qkv, mask, out, B, N, H, smem, s);
    case 4: return (int)launch<4>(qkv, mask, out, B, N, H, smem, s);
    case 9: return (int)launch<9>(qkv, mask, out, B, N, H, smem, s);
    case 13: return (int)launch<13>(qkv, mask, out, B, N, H, smem, s);
    default: return (int)launch<16>(qkv, mask, out, B, N, H, smem, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
