// Flash-attention forward over the fused qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel clibd_tpu/ops/pallas/attention.py::_flash_kernel.
// Same arithmetic: for each (batch, head), S = q.k^T / sqrt(hd) in fp32, plus
// an optional per-key additive mask ([B, N] fp32, HF convention: 0 or
// finfo(float32).min), an fp32 softmax, P rounded to bf16 after the
// normalisation, and P.V accumulated in fp32.  V is read as bf16.  The kernel
// reads q, k and v of head h straight from the fused [B, N, 3*H*hd] tensor
// (column offsets h*hd, D + h*hd, 2D + h*hd, row stride 3D) and writes ctx
// into [B, N, H*hd] at column h*hd (row stride D): no head-split copy ever
// exists in device memory.
//
// What bounds it on an H100: at N <= 197 and hd = 64 the work is
// 4*B*H*N^2*hd FLOPs and the bytes are the qkv read plus the ctx write
// (8*B*N*D bytes in bf16), N/2 FLOPs per byte: about 100 at N = 197, 67 at
// N = 133 and 10 at N = 20 -- all below the card's ~295 FLOP/byte ridge, so a
// kernel that keeps S and P on chip is bounded by device memory.  The plain
// version writes S and P to device memory ([B, H, N, N] fp32 and bf16) and
// reads them back, which is the traffic this kernel saves.
//
// Design (a first, simple one):
//  * one CTA per (batch, head), 4 warps;
//  * K (row-major) and V (transposed) of that head are staged in shared
//    memory as bf16, padded to a multiple of 16 keys with zero rows;
//  * each warp takes 16 query rows at a time, computes the whole 16 x Npad
//    score block with mma.sync m16n8k16 (bf16 in, fp32 accumulate) into
//    registers, takes the exact fp32 softmax over the row (the row never
//    leaves registers), rounds P to bf16 and multiplies it by V with
//    mma.sync, reusing the score accumulators as the A fragments of P.V;
//  * fp32 inputs (used for precision checks, not on the bf16 main path) go
//    through a SIMT kernel that keeps S in fp32 exactly as the reference does.
// Left on the table: wgmma and TMA, a producer warp that prefetches the next
// (batch, head) while this one computes, several heads per CTA so the q rows
// of one CTA fill all warps evenly (13 row tiles over 4 warps at N = 197),
// and the 5% of work spent on padded keys.

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel.  KT = number of 16-key tiles (Npad = 16*KT).
// ---------------------------------------------------------------------------
template <int KT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, int N, int H, float scale) {
  constexpr int NPAD = KT * 16;
  constexpr int KS = HD + 8;    // K row stride in bf16: conflict-free fragment loads
  constexpr int VS = NPAD + 8;  // V^T row stride in bf16: likewise
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vt = Ks + NPAD * KS;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * HD;
  const long rs = 3L * D;  // qkv row stride
  const __nv_bfloat16* qg = qkv + (long)b * N * rs + h * HD;
  const __nv_bfloat16* kg = qg + D;
  const __nv_bfloat16* vg = qg + 2 * D;

  // stage K and V^T; keys N..NPAD-1 are zero (their scores are masked to
  // -inf, and a zero V row keeps 0 * garbage out of the P.V sums)
  for (int idx = threadIdx.x; idx < NPAD * (HD / 8); idx += THREADS) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < N) {
      kv = *reinterpret_cast<const uint4*>(kg + r * rs + c);
      vv = *reinterpret_cast<const uint4*>(vg + r * rs + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * KS + c) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vt[(c + i) * VS + r] = ve[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // fragment column pair
  const float* mrow = mask ? mask + (long)b * N : nullptr;
  const int m_tiles = (N + 15) / 16;

  for (int mt = warp; mt < m_tiles; mt += WARPS) {
    float o[HD / 8][4];
    attend_rows_bf16<KT>(o, qg, rs, Ks, Vt, mrow, N, mt * 16, scale, g, t);
    const int r0 = mt * 16 + g;
    const int r1 = r0 + 8;
    __nv_bfloat16* orow0 = out + ((long)b * N + r0) * D + h * HD + t * 2;
    __nv_bfloat16* orow1 = orow0 + 8L * D;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      if (r0 < N)
        *reinterpret_cast<__nv_bfloat162*>(orow0 + dt * 8) = __floats2bfloat162_rn(o[dt][0], o[dt][1]);
      if (r1 < N)
        *reinterpret_cast<__nv_bfloat162*>(orow1 + dt * 8) = __floats2bfloat162_rn(o[dt][2], o[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT kernel, S exact in fp32.  One warp per query row; lane j scores
// keys j, j+32, ...; lane d accumulates output dims d and d+32.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                     float* __restrict__ out, int N, int H, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                  // [N][HD + 1]: conflict-free row-per-lane reads
  float* Vs = Ks + N * (HD + 1);     // [N][HD], rounded to bf16
  float* Qs = Vs + N * HD;           // [WARPS][HD]
  float* Ps = Qs + WARPS * HD;       // [WARPS][N]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * HD;
  const long rs = 3L * D;
  const float* qg = qkv + (long)b * N * rs + h * HD;
  const float* kg = qg + D;
  const float* vg = qg + 2 * D;

  for (int idx = threadIdx.x; idx < N * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    Ks[r * (HD + 1) + c] = kg[r * rs + c];
    Vs[r * HD + c] = __bfloat162float(__float2bfloat16_rn(vg[r * rs + c]));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* mrow = mask ? mask + (long)b * N : nullptr;
  float* qs = Qs + warp * HD;
  float* ps = Ps + warp * N;

  for (int r = warp; r < N; r += WARPS) {
    const float2 o = attend_row_f32(qg + r * rs, Ks, Vs, qs, ps, mrow, N, scale, lane);
    float* orow = out + ((long)b * N + r) * D + h * HD;
    orow[lane] = o.x;
    orow[lane + 32] = o.y;
  }
}

template <int KT>
cudaError_t launch_bf16(const void* qkv, const float* mask, void* out, int B, int N, int H,
                        float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(KT * 16 * (HD + 8) + HD * (KT * 16 + 8)) * sizeof(__nv_bfloat16);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_fwd_bf16_kernel<KT><<<B * H, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<__nv_bfloat16*>(out), N, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* qkv, const float* mask, void* out, int B, int N, int H,
                       float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(N * (HD + 1) + N * HD + WARPS * HD + WARPS * N) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_fwd_f32_kernel<<<B * H, THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), mask, static_cast<float*>(out), N, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*64] contiguous, bf16 (dtype 1) or fp32 (dtype 0); mask
// [B, N] fp32 contiguous or null; out [B, N, H*64] of qkv's dtype.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int clibd_flash_attention_qkv_fwd(const void* qkv, const float* mask, void* out, int B, int N,
                                  int H, int dtype, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > MAX_N || (long)B * H > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(qkv, mask, out, B, N, H, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (kt_instance(N)) {
    case 2: return (int)launch_bf16<2>(qkv, mask, out, B, N, H, scale, s);
    case 4: return (int)launch_bf16<4>(qkv, mask, out, B, N, H, scale, s);
    case 9: return (int)launch_bf16<9>(qkv, mask, out, B, N, H, scale, s);
    case 13: return (int)launch_bf16<13>(qkv, mask, out, B, N, H, scale, s);
    default: return (int)launch_bf16<16>(qkv, mask, out, B, N, H, scale, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int clibd_flash_attention_max_n(void) { return MAX_N; }

}  // extern "C"
