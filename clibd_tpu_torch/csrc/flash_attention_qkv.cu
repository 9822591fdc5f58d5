// Flash-attention forward over the fused qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel clibd_tpu/ops/pallas/attention.py::_flash_kernel.
// Same function: for each (batch, head), S = q.k^T / sqrt(hd) in fp32, plus
// an optional per-key additive mask ([B, N] fp32, HF convention: 0 or
// finfo(float32).min), an fp32 softmax, P rounded to bf16, and P.V
// accumulated in fp32.  V is read as bf16.  The kernel reads q, k and v of
// head h straight from the fused [B, N, 3*H*hd] tensor (column offsets h*hd,
// D + h*hd, 2D + h*hd, row stride 3D) and writes ctx into [B, N, H*hd] at
// column h*hd (row stride D): no head-split copy ever exists in device
// memory.  It takes any N >= 1.
//
// What bounds it on an H100: the work is 4*B*H*N^2*hd FLOPs and the bytes are
// the qkv read plus the ctx write (8*B*N*D bytes in bf16), N/2 FLOPs per
// byte: about 100 at N = 197, 67 at N = 133 and 10 at N = 20, all below the
// card's ~295 FLOP/byte ridge, so there a kernel that keeps S and P on chip is
// bounded by device memory; at N = 657 (the overlap-tokenizer DNA tower) it
// is 329, above the ridge, so the tensor cores bound it (0.67 ms of
// operations against 0.60 ms of bytes at B=500).  The plain version writes S
// and P to device memory ([B, H, N, N] fp32 and bf16) and reads them back.
//
// Design: key-tiled, with an online softmax (flash_common.cuh's
// attend_head_group<1>):
//  * one CTA of 4 warps per (batch, head, 64 query rows), each warp 16 rows:
//    B*H*ceil(N/64) CTAs (24,000 at ViT B=500) of 37 KB of shared memory
//    each, and at most 128 registers a thread (__launch_bounds__(128, 4)), so
//    four CTAs, 16 warps, share an SM: the warps in flight per SM decided
//    these kernels' times on this card (PERF.md);
//  * K and V stream in tiles of 64 keys, copied by cp.async straight from the
//    fused layout (row stride 3D) into a ring of two stages, the next tile's
//    copies in flight while this one is computed; V stays row-major and is
//    read by ldmatrix.trans, K by ldmatrix; keys past N are zero-filled by
//    the copy and masked to -inf, so nothing is padded in device memory;
//  * each warp keeps its 16 x 64 score block of one tile in registers
//    (mma.sync m16n8k16, bf16 in, fp32 accumulate), raises its running row
//    max, rescales its output and row sum, and multiplies P = exp(S - max)
//    rounded to bf16 by V, the score accumulators serving as the A fragments
//    of P.V; at the end it divides by the row sum.
// The one departure from the TPU kernel's arithmetic: P is rounded to bf16
// before the division by the row sum, not after (one sweep over the keys
// instead of two).  Each P differs from the reference's by at most one bf16
// rounding; the measured max |kernel - plain| at every shape is in PERF.md
// (the bound chip_smoke.py holds it to is 2e-2).  A fully masked row (every
// score finfo(float32).min) still comes out as the mean of V over every key:
// the running max starts at -inf, and the first tile raises it to that
// value, not past it.
//  * fp32 inputs (precision checks, not the bf16 main path) go through a SIMT
//    kernel with the same tiling that keeps S exact in fp32 and rounds P after
//    the normalisation, as the reference does (two sweeps over the keys:
//    flash_common.cuh's attend_head_f32).
// Left on the table: wgmma and TMA, exp2 with the scale folded in, and the
// K/V re-read of every query tile (from L2: 4 query tiles per (batch, head)
// at N = 197, 11 at N = 657).

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr size_t BF16_SMEM = 2 * group_stage_bytes(1);

__global__ void __launch_bounds__(THREADS, 4)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const HeadTile c = head_tile(N, H);
  const int D = H * HD;
  const long rs = 3L * D;
  float o[HD / 8][4];
  attend_head_group<1>(o, smem_raw, qkv + (long)c.b * N * rs, rs, D, H, c.h, N, c.r0,
                       mask ? mask + (long)c.b * N : nullptr, scale);
  const int lane = threadIdx.x % 32;
  store_rows(out + (long)c.b * N * D + c.h * HD, D, o, c.r0 + (threadIdx.x / 32) * 16, N,
             lane >> 2, lane & 3);
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                     float* __restrict__ out, int N, int H, float scale) {
  extern __shared__ float smem[];
  const HeadTile c = head_tile(N, H);
  const int D = H * HD;
  const long rs = 3L * D;
  const int lane = threadIdx.x % 32;
  float* orow = out + ((long)c.b * N + c.r0) * D + c.h * HD + lane;
  attend_head_f32<WARPS>(smem, qkv + (long)c.b * N * rs, rs, D, c.h, N, c.r0,
                         mask ? mask + (long)c.b * N : nullptr, scale,
                         [&](int r, float o0, float o1) {
                           orow[(long)r * D] = o0;
                           orow[(long)r * D + 32] = o1;
                         });
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*64] contiguous, bf16 (dtype 1) or fp32 (dtype 0); mask
// [B, N] fp32 contiguous or null; out [B, N, H*64] of qkv's dtype.  Any
// N >= 1 whose grid, B*H*ceil(N/64) CTAs, fits.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int clibd_flash_attention_qkv_fwd(const void* qkv, const float* mask, void* out, int B, int N,
                                  int H, int dtype, void* stream) {
  const long grid = (long)B * H * ((N + KTILE - 1) / KTILE);
  if (B < 1 || H < 1 || N < 1 || grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    flash_fwd_bf16_kernel<<<grid, THREADS, BF16_SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<__nv_bfloat16*>(out), N, H,
        scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = f32_attn_bytes(WARPS);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_f32_kernel<<<grid, THREADS, smem, s>>>(static_cast<const float*>(qkv), mask,
                                                   static_cast<float*>(out), N, H, scale);
  return (int)cudaGetLastError();
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
