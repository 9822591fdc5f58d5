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
// row).  The head loop is attend_heads_to_ctx below.
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

// bytes of one head's K and V, each row-major at row stride HD+8 in bf16,
// for npad keys: one buffer of attend_heads_to_ctx's ring
__host__ __device__ constexpr size_t kv_rows_bytes(int npad) {
  return (size_t)2 * npad * (HD + 8) * sizeof(__nv_bfloat16);
}

// Every head's attention for the query rows q0 .. q0+rows-1 (rows <= 64) of
// one batch element, into the bf16 context tile `ctx` ([64][D+8] in shared
// memory) at column h*HD.  `base` is the element's fused qkv (row stride
// `rs`), `mrow` its key mask or null.  The heads go GROUP at a time over
// 4*GROUP warps: warp w attends over head h0 + w/4 for the 16-row tile w%4
// (attend_rows_bf16, V row-major).  Each group's K and V are copied by
// cp.async into a ring of STAGES buffers of GROUP heads at `kv`
// (STAGES*GROUP*kv_rows_bytes(16*KT) bytes); with two stages the next
// group's copies are in flight while this group computes.  Keys N .. 16*KT-1
// are zero in every buffer.  Returns after a barrier: the tile is complete
// and `kv` is free.
template <int KT, int GROUP, int STAGES>
__device__ __forceinline__ void attend_heads_to_ctx(__nv_bfloat16* ctx, unsigned char* kv,
                                                    const __nv_bfloat16* base, long rs,
                                                    const float* mrow, int N, int H, int q0,
                                                    int rows, float scale) {
  constexpr int NPAD = KT * 16;
  constexpr int KS = HD + 8;
  constexpr int THREADS = GROUP * 128;
  constexpr int CHUNKS = HD / 8;  // 16-byte pieces of a head's row
  const int D = H * HD;
  const int CS = D + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % 4, grp = warp / 4;
  // K of buffer `buf` (= stage * GROUP + head in group); V follows it
  auto k_of = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(kv + buf * kv_rows_bytes(NPAD));
  };

  const int pad = NPAD - N;
  for (int idx = threadIdx.x; idx < STAGES * GROUP * 2 * pad * CHUNKS; idx += THREADS) {
    const int c = (idx % CHUNKS) * 8;
    const int r = N + (idx / CHUNKS) % pad;
    const int half = idx / CHUNKS / pad;  // (buffer, K or V)
    *reinterpret_cast<uint4*>(k_of(half / 2) + (half % 2) * NPAD * KS + r * KS + c) =
        make_uint4(0, 0, 0, 0);
  }
  auto issue = [&](int i) {  // group i's K and V into stage i % STAGES
    for (int idx = threadIdx.x; idx < GROUP * 2 * N * CHUNKS; idx += THREADS) {
      const int c = (idx % CHUNKS) * 8;
      const int r = (idx / CHUNKS) % N;
      const int half = idx / CHUNKS / N;  // (head in group, K or V)
      const int h = i * GROUP + half / 2;
      if (h < H)
        cp_async16(k_of((i % STAGES) * GROUP + half / 2) + (half % 2) * NPAD * KS + r * KS + c,
                   base + r * rs + (1 + half % 2) * D + h * HD + c);
    }
    cp_async_commit();
  };

  const int groups = (H + GROUP - 1) / GROUP;
  issue(0);
  for (int i = 0; i < groups; ++i) {
    if (STAGES > 1 && i + 1 < groups) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // group i's K and V have landed, for every thread
    const int h = i * GROUP + grp;
    if (mt * 16 < rows && h < H) {
      const __nv_bfloat16* Ks = k_of((i % STAGES) * GROUP + grp);
      float o[HD / 8][4];
      attend_rows_bf16<KT, true>(o, base + h * HD, rs, Ks, Ks + NPAD * KS, mrow, N, q0 + mt * 16,
                                 scale, g, t);
      __nv_bfloat16* c0 = ctx + (mt * 16 + g) * CS + h * HD + t * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(c0 + dt * 8) = __floats2bfloat162_rn(o[dt][0], o[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(c0 + 8 * CS + dt * 8) =
            __floats2bfloat162_rn(o[dt][2], o[dt][3]);
      }
    }
    __syncthreads();  // this stage's buffers are no longer read
    if (STAGES == 1 && i + 1 < groups) issue(i + 1);
  }
}

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
