// Flash attention over the fused qkv projection with the attention
// out-projection fused in, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// clibd_tpu/ops/pallas/attention.py::_flash_outproj_kernel.  Same function:
// per (batch, head) the attention of flash_attention_qkv.cu (S = q.k^T / 8 in
// fp32 plus the optional [B, N] key mask, the fp32 row softmax, P rounded to
// bf16, V read as bf16, P.V accumulated in fp32), the context rounded to
// bf16, then out = ctx . bf16(W_out) accumulated in fp32 plus the fp32 bias,
// cast to qkv's dtype.  The context never reaches device memory: it lives in
// shared memory between the two phases.  It takes any N >= 1.
//
// What bounds it on an H100: the bytes are qkv read and out written (8*B*N*D
// bytes in bf16: 606 MB at the ViT shape B=500 N=197 D=768, 0.181 ms at
// 3.35 TB/s) plus W_out once; the tensor-core work is 4*B*H*N^2*64 FLOPs of
// attention and 2*B*N*D^2 of projection (60 + 116 GFLOP there, 0.178 ms at
// 989 TFLOP/s).  The two are within 2% of each other, so neither device memory
// nor the tensor cores alone would bound a good kernel.  Unfused, the
// context costs a [B, N, D] write and read (303 MB) on top.
//
// Design.  The TPU kernel keeps a whole batch element's [N, D] bf16 context
// in VMEM (296 KB at N=197, D=768), more than the 227 KB of shared memory a
// CTA can have, so the queries are tiled instead:
//  * one CTA per (batch, 64 query rows), 8 warps; warp w takes rows
//    16*(w%4) .. +16 of the tile;
//  * attention, one head pair at a time, through the forward kernel's
//    key-tiled core (flash_common.cuh's attend_head_group<2>): the K and V of
//    heads h and h+1 stream in tiles of 64 keys through a two-stage cp.async
//    ring, warps 0-3 attend over head h and warps 4-7 over head h+1 with an
//    online softmax, and each writes its bf16 context into the CTA's [64, D]
//    context tile.  No row of keys is held, so any N is taken; P is rounded
//    to bf16 before the division by the row sum, as in the forward kernel;
//  * projection: W_out is streamed through shared memory in [128, 128] bf16
//    chunks with cp.async, double-buffered in the space the K/V tiles used;
//    warp w multiplies its 16 context rows by the chunk's column half w/4
//    with mma.sync (B operand by ldmatrix.trans), accumulating in fp32 over
//    the D/128 chunks of a column block, then adds the bias and stores;
//  * fp32 qkv (precision checks, not the bf16 main path) takes the forward
//    kernel's SIMT core with S exact in fp32 (attend_head_f32), one head at a
//    time, and the same projection (the context is bf16 in both, as in the
//    TPU kernel).
// Shared memory: the context tile, 64 x (D+8) bf16 (99 KB at D=768), plus
// the larger of the two-stage ring (2 x (2 heads' K and V tiles + the key
// row) = 74 KB) and two W chunks (70 KB): 173 KB at D=768, so one CTA per
// SM.  Left on the table: wgmma and TMA, a tile that fits two CTAs per SM,
// the K/V re-read of every query tile, W_out re-read from L2 by every CTA.

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QROWS = 64;  // query rows per CTA: 4 tiles of 16
constexpr int KC = 128;    // W_out chunk: k rows
constexpr int NC = 128;    // W_out chunk: output columns (64 per warp)
constexpr int WS = NC + 8; // W_out chunk row stride in bf16: conflict-free ldmatrix

constexpr size_t W_BYTES = 2 * (size_t)KC * WS * 2;  // two W_out chunks

// ---------------------------------------------------------------------------
// Projection: out[q0 + r, :] = ctx[r, :] . W + bias for the CTA's rows below N.
// `wbuf` holds two chunks of KC x WS bf16.
// ---------------------------------------------------------------------------
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float a, float b);

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void load_w_chunk(__nv_bfloat16* dst, const __nv_bfloat16* w, int kc,
                                             int nc, int D) {
  for (int idx = threadIdx.x; idx < KC * (NC / 8); idx += THREADS) {
    const int r = idx / (NC / 8);
    const int c = (idx % (NC / 8)) * 8;
    cp_async16(dst + r * WS + c, w + (long)(kc * KC + r) * D + nc * NC + c);
  }
}

template <typename OutT>
__device__ void project(const __nv_bfloat16* ctx, __nv_bfloat16* wbuf,
                        const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                        OutT* __restrict__ out, long out_row0, int rows, int D) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % 4;       // 16-row tile
  const int half = warp / 4;     // 64-column half of each chunk
  const int CS = D + 8;
  const int kchunks = D / KC, total = (D / NC) * kchunks;
  float acc[8][4];

  load_w_chunk(wbuf, w, 0, 0, D);
  cp_async_commit();
  for (int i = 0; i < total; ++i) {
    const int nc = i / kchunks, kc = i % kchunks;
    cp_async_wait_all();
    __syncthreads();  // chunk i landed for all; chunk i-1's buffer is free
    if (i + 1 < total)
      load_w_chunk(wbuf + ((i + 1) & 1) * KC * WS, w, (i + 1) % kchunks, (i + 1) / kchunks, D);
    cp_async_commit();
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    const __nv_bfloat16* wb = wbuf + (i & 1) * KC * WS;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      ld_a_frag(a, ctx, CS, mt * 16, kc * KC + ks * 16, g, t);
      mma_kmajor<8>(acc, a, wb, WS, ks * 16, half * 64, lane);
    }
    if (kc == kchunks - 1) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nc * NC + half * 64 + j * 8 + t * 2;
        const float b0 = bias[col], b1 = bias[col + 1];
        if (r0 < rows) store_pair(out + (out_row0 + r0) * D + col, acc[j][0] + b0, acc[j][1] + b1);
        if (r1 < rows) store_pair(out + (out_row0 + r1) * D + col, acc[j][2] + b0, acc[j][3] + b1);
      }
    }
  }
}

// zero the context rows at or past N, so the projection multiplies no stale
// shared memory
__device__ __forceinline__ void zero_dead_rows(__nv_bfloat16* ctx, int rows, int D) {
  const int CS = D + 8;
  for (int idx = threadIdx.x; idx < (QROWS - rows) * (D / 8); idx += THREADS) {
    const int r = rows + idx / (D / 8), c = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(ctx + r * CS + c) = make_uint4(0, 0, 0, 0);
  }
}

// (batch, first query row, live rows) of this CTA
struct Tile {
  int b, q0, rows;
};

__device__ __forceinline__ Tile cta_tile(int N) {
  const int qtiles = (N + QROWS - 1) / QROWS;
  const int q0 = (blockIdx.x % qtiles) * QROWS;
  return {(int)(blockIdx.x / qtiles), q0, min(QROWS, N - q0)};
}

// ---------------------------------------------------------------------------
// bf16: tensor-core attention, two heads at a time.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
outproj_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * HD;
  const int CS = D + 8;
  __nv_bfloat16* ctx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* region = smem_raw + ctx_tile_bytes(D);
  const Tile c = cta_tile(N);
  const long rs = 3L * D;
  const __nv_bfloat16* base = qkv + (long)c.b * N * rs;
  const float* mrow = mask ? mask + (long)c.b * N : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  for (int h0 = 0; h0 < H; h0 += WARPS / 4) {
    float o[HD / 8][4];
    attend_head_group<WARPS / 4>(o, region, base, rs, D, H, h0, N, c.q0, mrow, scale);
    const int h = h0 + warp / 4;
    if (h < H) {
      __nv_bfloat16* c0 = ctx + ((warp % 4) * 16 + g) * CS + h * HD + t * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(c0 + dt * 8) = __floats2bfloat162_rn(o[dt][0], o[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(c0 + 8 * CS + dt * 8) =
            __floats2bfloat162_rn(o[dt][2], o[dt][3]);
      }
    }
  }
  __syncthreads();  // the context tile is complete
  project(ctx, reinterpret_cast<__nv_bfloat16*>(region), w, bias, out, (long)c.b * N + c.q0,
          c.rows, D);
}

// ---------------------------------------------------------------------------
// fp32: SIMT attention with S exact in fp32, one head at a time, then the
// same bf16 projection.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
outproj_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ out, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * HD;
  const int CS = D + 8;
  __nv_bfloat16* ctx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* region = smem_raw + ctx_tile_bytes(D);
  const Tile c = cta_tile(N);
  const long rs = 3L * D;
  const float* base = qkv + (long)c.b * N * rs;
  const float* mrow = mask ? mask + (long)c.b * N : nullptr;
  const int lane = threadIdx.x % 32;

  zero_dead_rows(ctx, c.rows, D);
  for (int h = 0; h < H; ++h)
    attend_head_f32<WARPS>(reinterpret_cast<float*>(region), base, rs, D, h, N, c.q0, mrow, scale,
                           [&](int r, float o0, float o1) {
                             ctx[r * CS + h * HD + lane] = __float2bfloat16_rn(o0);
                             ctx[r * CS + h * HD + lane + 32] = __float2bfloat16_rn(o1);
                           });
  project(ctx, reinterpret_cast<__nv_bfloat16*>(region), w, bias, out, (long)c.b * N + c.q0,
          c.rows, D);
}

// shared memory of a launch, or 0 where the shapes are not taken
size_t smem_bytes(int N, int H, int dtype) {
  const int D = H * HD;
  if (N < 1 || H < 2 || D % KC) return 0;
  const size_t attn = dtype == 1 ? 2 * group_stage_bytes(WARPS / 4) : f32_attn_bytes(WARPS);
  return ctx_tile_bytes(D) + (attn > W_BYTES ? attn : W_BYTES);
}

}  // namespace

extern "C" {

// Shared memory a launch at (N, H, dtype) needs, 0 where the kernel does not
// take the shapes (D = 64*H not a multiple of 128).
long clibd_flash_outproj_smem_bytes(int N, int H, int dtype) {
  return (long)smem_bytes(N, H, dtype);
}

// qkv [B, N, 3*H*64] contiguous, bf16 (dtype 1) or fp32 (dtype 0); mask [B, N]
// fp32 or null; w [H*64, H*64] bf16 ([in, out]); bias [H*64] fp32; out
// [B, N, H*64] of qkv's dtype.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int clibd_flash_attention_qkv_outproj(const void* qkv, const float* mask, const void* w,
                                      const float* bias, void* out, int B, int N, int H,
                                      int dtype, void* stream) {
  const size_t smem = smem_bytes(N, H, dtype);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long grid = (long)B * ((N + QROWS - 1) / QROWS);
  if (B < 1 || smem == 0 || smem > (size_t)max_smem || grid > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)HD);
  if (dtype == 0) {
    cudaError_t e = cudaFuncSetAttribute(outproj_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    outproj_f32_kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(qkv), mask, static_cast<const __nv_bfloat16*>(w), bias,
        static_cast<float*>(out), N, H, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(outproj_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  outproj_bf16_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), N, H, scale);
  return (int)cudaGetLastError();
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
