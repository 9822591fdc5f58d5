// Fused transformer MLP, act(x.W1 + b1).W2 + b2, for Hopper (sm_90a).
//
// Replaces the TPU kernel clibd_tpu/ops/pallas/mlp.py::_mlp_kernel.  Same
// arithmetic: h = x.W1 accumulated in fp32, plus the fp32 bias, the
// activation in fp32, h rounded to x's dtype, then h.W2 accumulated in fp32
// over F chunks, plus the fp32 bias, cast to x's dtype.  The [R, F]
// intermediate never reaches device memory.
//
// What bounds it on an H100: 4*R*D*F FLOPs (0.93 TFLOP at the ViT shape
// R=500*197, D=768, F=3072: 0.94 ms at 989 TFLOP/s) against x read and out
// written plus both weights once (4*R*D + 4*D*F bytes in bf16: 312 MB, 0.093
// ms at 3.35 TB/s), so the tensor cores bound it, about 3000 FLOPs per byte.
// Unfused, the intermediate costs a [R, F] write and read (1.2 GB) on top.
//
// Design (a first, simple one).  The TPU kernel holds a [512, D] fp32
// accumulator in VMEM (1.5 MB); on Hopper a row block's accumulator has to
// live in registers, so the row block is small and the weights are streamed:
//  * one CTA per 64 rows of x, 8 warps; warp w owns rows 16*(w%4) .. +16 and,
//    of every 256 output columns, the half w/4: D/2 accumulator columns, so
//    3*D/8 fp32 registers a thread (96 at D=256, 192 at D=768);
//  * the x tile stays in shared memory for the whole CTA (ragged row tails
//    zero-filled in the kernel, no padding in device memory);
//  * F is walked in chunks of 64.  Per chunk: h = x.W1[:, chunk] with
//    mma.sync over D in W1 pieces of [128, 64]; bias and activation in fp32;
//    h rounded to bf16 into shared memory; then acc += h.W2[chunk, :] in W2
//    pieces of [64, 256];
//  * every weight piece comes through a pair of shared-memory buffers with
//    cp.async, the next piece in flight while the current one is multiplied;
//    B operands by ldmatrix.trans from the row-major pieces;
//  * fp32 inputs (precision checks, not the bf16 main path) go through a
//    SIMT kernel with the same chunking and fp32 throughout.
// The TPU kernel's f_block divisor clamp is a Mosaic constraint with no
// counterpart here.  Left on the table: wgmma and TMA, a row block wide
// enough to cut the weights' re-reads from L2 (each CTA streams both weights,
// 9.4 MB at D=768), and two CTAs per SM.

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 64;         // rows of x per CTA: 4 tiles of 16
constexpr int FC = 64;           // F chunk
constexpr int K1 = 128;          // W1 piece: k rows (of D)
constexpr int N2 = 256;          // W2 piece: output columns (of D)
constexpr int W1S = FC + 8;      // W1 piece row stride in bf16
constexpr int W2S = N2 + 8;      // W2 piece row stride in bf16
constexpr int HS = FC + 8;       // h tile row stride in bf16
constexpr int PIECE = K1 * W1S > FC * W2S ? K1 * W1S : FC * W2S;  // bf16 per buffer

enum Act { GELU_TANH = 0, GELU = 1, QUICK_GELU = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == GELU_TANH) return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (act == GELU) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return v / (1.f + expf(-1.702f * v));
}

__host__ __device__ constexpr size_t bf16_smem(int D) {
  return (size_t)(ROWS * (D + 8) + ROWS * HS + 2 * PIECE) * 2;
}

// weight piece s of F chunk fc: s < D/K1 is W1[s*K1 .. +K1, fc*FC .. +FC];
// else W2[fc*FC .. +FC, q*N2 .. +N2] with q = s - D/K1
__device__ __forceinline__ void load_piece(__nv_bfloat16* dst, const __nv_bfloat16* w1,
                                           const __nv_bfloat16* w2, int fc, int s, int D, int F) {
  const int p1 = D / K1;
  if (s < p1) {
    for (int idx = threadIdx.x; idx < K1 * (FC / 8); idx += THREADS) {
      const int r = idx / (FC / 8), c = (idx % (FC / 8)) * 8;
      cp_async16(dst + r * W1S + c, w1 + (long)(s * K1 + r) * F + fc * FC + c);
    }
  } else {
    const int q = s - p1;
    for (int idx = threadIdx.x; idx < FC * (N2 / 8); idx += THREADS) {
      const int r = idx / (N2 / 8), c = (idx % (N2 / 8)) * 8;
      cp_async16(dst + r * W2S + c, w2 + (long)(fc * FC + r) * D + q * N2 + c);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel, D a multiple of 256 (template), F of 64.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int R, int F,
                int act) {
  constexpr int XS = D + 8;        // x tile row stride
  constexpr int P1 = D / K1;       // W1 pieces per chunk
  constexpr int P2 = D / N2;       // W2 pieces per chunk
  constexpr int NT1 = FC / 2 / 8;  // h n-tiles per warp (32 columns)
  constexpr int NT2 = N2 / 2 / 8;  // accumulator n-tiles per warp and W2 piece (128 columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = xs + ROWS * XS;
  __nv_bfloat16* stage = hs + ROWS * HS;

  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, R - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % 4;    // 16-row tile
  const int half = warp / 4;  // column half
  const int chunks = F / FC;

  // the x tile (rows past R zero) and the first weight piece, one group
  for (int idx = threadIdx.x; idx < ROWS * (D / 8); idx += THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    if (r < rows)
      cp_async16(xs + r * XS + c, x + (long)(row0 + r) * D + c);
    else
      *reinterpret_cast<uint4*>(xs + r * XS + c) = make_uint4(0, 0, 0, 0);
  }
  load_piece(stage, w1, w2, 0, 0, D, F);
  cp_async_commit();

  float acc[P2 * NT2][4];
#pragma unroll
  for (int j = 0; j < P2 * NT2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int step = 0;  // pieces consumed so far: the buffer parity
  // wait for the current piece, then put the next one in flight
  auto advance = [&](int fc, int s) {
    cp_async_wait_all();
    __syncthreads();
    int nfc = fc, ns = s + 1;
    if (ns == P1 + P2) { nfc = fc + 1; ns = 0; }
    if (nfc < chunks) load_piece(stage + ((step + 1) & 1) * PIECE, w1, w2, nfc, ns, D, F);
    cp_async_commit();
  };

  for (int fc = 0; fc < chunks; ++fc) {
    float hacc[NT1][4];
#pragma unroll
    for (int j = 0; j < NT1; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < P1; ++s) {
      advance(fc, s);
      const __nv_bfloat16* wp = stage + (step & 1) * PIECE;
#pragma unroll
      for (int ks = 0; ks < K1 / 16; ++ks) {
        uint32_t a[4];
        ld_a_frag(a, xs, XS, mt * 16, s * K1 + ks * 16, g, t);
        mma_kmajor<NT1>(hacc, a, wp, W1S, ks * 16, half * (FC / 2), lane);
      }
      ++step;
    }
    // bias and activation in fp32, h rounded to bf16 into shared memory; the
    // barrier of the next advance() orders these stores before any read
    {
      __nv_bfloat16* h0 = hs + (mt * 16 + g) * HS + half * (FC / 2) + t * 2;
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int f = fc * FC + half * (FC / 2) + j * 8 + t * 2;
        const float c0 = b1[f], c1 = b1[f + 1];
        *reinterpret_cast<__nv_bfloat162*>(h0 + j * 8) = __floats2bfloat162_rn(
            activate(hacc[j][0] + c0, act), activate(hacc[j][1] + c1, act));
        *reinterpret_cast<__nv_bfloat162*>(h0 + 8 * HS + j * 8) = __floats2bfloat162_rn(
            activate(hacc[j][2] + c0, act), activate(hacc[j][3] + c1, act));
      }
    }
#pragma unroll
    for (int q = 0; q < P2; ++q) {
      advance(fc, P1 + q);
      const __nv_bfloat16* wp = stage + (step & 1) * PIECE;
#pragma unroll
      for (int ks = 0; ks < FC / 16; ++ks) {
        uint32_t a[4];
        ld_a_frag(a, hs, HS, mt * 16, ks * 16, g, t);
        // acc[q*NT2 + j] += h . W2 piece, as mma_kmajor with the offset
        // spelled out so that every accumulator index is a constant
        const __nv_bfloat16* p = wp + (ks * 16 + (lane & 15)) * W2S + half * (N2 / 2) + (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NT2; j += 2) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, p + j * 8);
          mma_bf16_16816(acc[q * NT2 + j], a, bfr[0], bfr[1]);
          mma_bf16_16816(acc[q * NT2 + j + 1], a, bfr[2], bfr[3]);
        }
      }
      ++step;
    }
  }

  const int r0 = mt * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int q = 0; q < P2; ++q) {
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      const int col = q * N2 + half * (N2 / 2) + j * 8 + t * 2;
      const float c0 = b2[col], c1 = b2[col + 1];
      const float* a = acc[q * NT2 + j];
      if (r0 < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (long)(row0 + r0) * D + col) =
            __floats2bfloat162_rn(a[0] + c0, a[1] + c1);
      if (r1 < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (long)(row0 + r1) * D + col) =
            __floats2bfloat162_rn(a[2] + c0, a[3] + c1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT kernel, 16 rows per CTA, the accumulator in shared memory.
// ---------------------------------------------------------------------------
constexpr int F32_ROWS = 16;

__host__ __device__ constexpr size_t f32_smem(int D) {
  return (size_t)(2 * F32_ROWS * D + F32_ROWS * FC) * 4;
}

__global__ void __launch_bounds__(THREADS)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int R, int D, int F,
               int act) {
  extern __shared__ __align__(16) float fsmem[];
  float* xs = fsmem;                  // [F32_ROWS][D]
  float* acc = xs + F32_ROWS * D;     // [F32_ROWS][D]
  float* hs = acc + F32_ROWS * D;     // [F32_ROWS][FC]
  const int row0 = blockIdx.x * F32_ROWS;
  const int rows = min(F32_ROWS, R - row0);
  for (int e = threadIdx.x; e < F32_ROWS * D; e += THREADS) {
    const int r = e / D;
    xs[e] = r < rows ? x[(long)(row0 + r) * D + e % D] : 0.f;
    acc[e] = 0.f;
  }
  for (int f0 = 0; f0 < F; f0 += FC) {
    __syncthreads();  // xs ready; the previous chunk's h no longer read
    for (int e = threadIdx.x; e < F32_ROWS * FC; e += THREADS) {
      const int r = e / FC, f = f0 + e % FC;
      float v = 0.f;
      if (f < F) {
        for (int d = 0; d < D; ++d) v = fmaf(xs[r * D + d], w1[(long)d * F + f], v);
        v = activate(v + b1[f], act);
      }
      hs[e] = v;
    }
    __syncthreads();
    const int fn = min(FC, F - f0);
    for (int e = threadIdx.x; e < F32_ROWS * D; e += THREADS) {
      const int r = e / D, d = e % D;
      float v = acc[e];
      for (int c = 0; c < fn; ++c) v = fmaf(hs[r * FC + c], w2[(long)(f0 + c) * D + d], v);
      acc[e] = v;
    }
  }
  for (int e = threadIdx.x; e < rows * D; e += THREADS)
    out[(long)row0 * D + e] = acc[e] + b2[e % D];
}

template <int D>
cudaError_t launch_bf16(const void* x, const void* w1, const float* b1, const void* w2,
                        const float* b2, void* out, int R, int F, int act, cudaStream_t stream) {
  const size_t smem = bf16_smem(D);
  cudaError_t e = cudaFuncSetAttribute(mlp_bf16_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mlp_bf16_kernel<D><<<(R + ROWS - 1) / ROWS, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1), b1,
      static_cast<const __nv_bfloat16*>(w2), b2, static_cast<__nv_bfloat16*>(out), R, F, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether the kernel takes (D, F) in `dtype` (1 bf16, 0 fp32): bf16 needs D
// in {256, 512, 768} and F a multiple of 64; fp32 needs its accumulator tile
// to fit in shared memory.
int clibd_fused_mlp_supported(int D, int F, int dtype) {
  if (D < 1 || F < 1) return 0;
  if (dtype == 1) return (D == 256 || D == 512 || D == 768) && F % FC == 0;
  return dtype == 0 && f32_smem(D) <= 227 * 1024;
}

// x [R, D] contiguous, bf16 (dtype 1) or fp32 (dtype 0); w1 [D, F] and w2
// [F, D] of x's dtype; b1 [F] and b2 [D] fp32; out [R, D] of x's dtype; act 0
// gelu_tanh, 1 gelu (erf), 2 quick_gelu.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int clibd_fused_mlp(const void* x, const void* w1, const float* b1, const void* w2,
                    const float* b2, void* out, int R, int D, int F, int act, int dtype,
                    void* stream) {
  if (R < 1 || act < 0 || act > 2 || !clibd_fused_mlp_supported(D, F, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem = f32_smem(D);
    cudaError_t e = cudaFuncSetAttribute(mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    mlp_f32_kernel<<<(R + F32_ROWS - 1) / F32_ROWS, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1,
        static_cast<const float*>(w2), b2, static_cast<float*>(out), R, D, F, act);
    return (int)cudaGetLastError();
  }
  if (D == 256) return (int)launch_bf16<256>(x, w1, b1, w2, b2, out, R, F, act, s);
  if (D == 512) return (int)launch_bf16<512>(x, w1, b1, w2, b2, out, R, F, act, s);
  return (int)launch_bf16<768>(x, w1, b1, w2, b2, out, R, F, act, s);
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
