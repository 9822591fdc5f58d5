// Tiled GEMM C = A . B, bf16 in, fp32 accumulate, fp32 or bf16 out, for
// Hopper (sm_90a): the matrix-unit probe.
//
// Replaces three TPU kernels that compute the same product with an fp32
// accumulator: tools/exp_attn.py::probe_pallas_matmul's `kern` (one program,
// 1024^3), tools/exp_mxu.py::make_tiled (grid (M/tm, N/tn, K/512), 2048^3)
// and tools/exp_mxu2.py::make_tiled (the same at 8192^3 with a tile sweep and
// a bf16 or fp32 out).  A is [M, K] and B is [K, N], both row-major bf16, as
// in the TPU kernels; C is [M, N] row-major.
//
// What bounds it on an H100: 2*M*N*K operations against (M*K + K*N) * 2 +
// M*N * (4 or 2) bytes.  At 2048^3 that is 17.2 GFLOP (0.0174 ms at 989
// TFLOP/s) against 33.6 MB (0.0100 ms at 3.35 TB/s), and at 8192^3 1.10
// TFLOP (1.112 ms): the tensor cores bound it.  At 1024^3 the bytes (8.39
// MB, 0.0025 ms) edge out the operations (2.15 GFLOP, 0.0022 ms).
//
// Design (a first, simple one).  The TPU tiles (256-1024 rows, tk 512-2048)
// are VMEM blocks whose fp32 accumulator would be 1 MB per CTA here, so they
// are not carried over; the tile is a template parameter (BM, BN, BK, the
// warp grid and the number of stages), instantiated a few times and exported
// by name, so the sweep asks the TPU scripts' question (tile shape, K depth,
// out dtype) in Hopper terms:
//  * one CTA per BM x BN tile of C, WARPS_M x WARPS_N warps, each warp a
//    (BM/WARPS_M) x (BN/WARPS_N) sub-tile held as fp32 accumulators in
//    registers; the K loop runs inside the CTA, in place of the TPU grid's
//    sequential third dimension and its accumulator scratch;
//  * A and B tiles stream through a STAGES-deep cp.async ring in shared
//    memory (STAGES - 1 tiles in flight while one is multiplied), rows
//    padded by 8 bf16 so that every ldmatrix phase hits 8 distinct bank
//    groups;
//  * per 16-deep k step a warp loads its A fragments with ldmatrix and its B
//    fragments with ldmatrix.trans (B is k-major), then issues every
//    mma.sync.m16n8k16 of its sub-tile;
//  * the epilogue writes the accumulators straight to C (fp32, or rounded to
//    bf16 once).
// M, N and K must be multiples of the tile, as the TPU grid requires.
// Deliberately absent: the TPU's `dimension_semantics` (CTAs of a CUDA grid
// are independent by construction) and `pl.dot` against `jnp.dot` (one
// product instruction here).  Left on the table: wgmma and TMA (the only way
// to the card's full tensor-core rate), a persistent grid with a swizzled
// tile order for L2 reuse, split-K for small grids.

#include "flash_common.cuh"

namespace {

using namespace clibd;

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES>
struct Tile {
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int AS = BK + 8;  // A tile row stride in bf16
  static constexpr int BS = BN + 8;  // B tile row stride in bf16
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;  // 16-row m-tiles per warp
  static constexpr int NT = WN / 8;   // 8-column n-tiles per warp
  static constexpr int STAGE = BM * AS + BK * BS;  // bf16 per stage
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(__nv_bfloat16);
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile");
  static_assert((BM * BK / 8) % THREADS == 0 && (BK * BN / 8) % THREADS == 0, "loader");
};

// stage `kt`'s A [BM, BK] and B [BK, BN] tiles into `smem`, 16 bytes a copy
template <class T, int BM, int BN, int BK>
__device__ __forceinline__ void load_stage(__nv_bfloat16* smem, const __nv_bfloat16* A,
                                           const __nv_bfloat16* B, int m0, int n0, int kt, int N,
                                           int K) {
  __nv_bfloat16* As = smem;
  __nv_bfloat16* Bs = smem + BM * T::AS;
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / T::THREADS; ++i) {
    const int idx = threadIdx.x + i * T::THREADS;
    const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
    cp_async16(As + r * T::AS + c, A + (long)(m0 + r) * K + kt * BK + c);
  }
#pragma unroll
  for (int i = 0; i < BK * BN / 8 / T::THREADS; ++i) {
    const int idx = threadIdx.x + i * T::THREADS;
    const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
    cp_async16(Bs + r * T::BS + c, B + (long)(kt * BK + r) * N + n0 + c);
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES, bool OUT_BF16>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 1)
gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
            void* __restrict__ C, int M, int N, int K) {
  using T = Tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / WARPS_N) * T::WM, wn = (warp % WARPS_N) * T::WN;
  const int g = lane >> 2, t = lane & 3;
  const int KT = K / BK;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // the first STAGES - 1 tiles in flight, one commit group each (empty past K)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage<T, BM, BN, BK>(smem + s * T::STAGE, A, B, m0, n0, s, N, K);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    // tile kt has landed; the barrier also retires every warp's reads of the
    // slot that the next load overwrites (the one multiplied at kt - 1)
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load_stage<T, BM, BN, BK>(smem + (next % STAGES) * T::STAGE, A, B, m0, n0,
                                             next, N, K);
    cp_async_commit();

    const __nv_bfloat16* As = smem + (kt % STAGES) * T::STAGE;
    const __nv_bfloat16* Bs = As + BM * T::AS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        ldmatrix_x4(a[i], As + (wm + i * 16 + (lane & 15)) * T::AS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < T::NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Bs + (ks * 16 + (lane & 15)) * T::BS + wn + j * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_bf16_16816(acc[i][j], a[i], b[0], b[1]);
          mma_bf16_16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
    const long r0 = m0 + wm + i * 16 + g;
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const long c = n0 + wn + j * 8 + t * 2;
      if (OUT_BF16) {
        __nv_bfloat16* Cb = static_cast<__nv_bfloat16*>(C);
        *reinterpret_cast<__nv_bfloat162*>(Cb + r0 * N + c) =
            __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<__nv_bfloat162*>(Cb + (r0 + 8) * N + c) =
            __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
      } else {
        float* Cf = static_cast<float*>(C);
        *reinterpret_cast<float2*>(Cf + r0 * N + c) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(Cf + (r0 + 8) * N + c) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES, bool OUT_BF16>
cudaError_t launch_typed(const void* A, const void* B, void* C, int M, int N, int K,
                         cudaStream_t stream) {
  using T = Tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES>;
  auto kernel = gemm_kernel<BM, BN, BK, WARPS_M, WARPS_N, STAGES, OUT_BF16>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)T::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(N / BN, M / BM), T::THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B), C, M, N, K);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES>
int launch(const void* A, const void* B, void* C, int M, int N, int K, int out_dtype,
           void* stream) {
  if (M < BM || N < BN || K < BK || M % BM || N % BN || K % BK || M / BM > 65535 ||
      ((uintptr_t)A | (uintptr_t)B | (uintptr_t)C) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return (int)launch_typed<BM, BN, BK, WARPS_M, WARPS_N, STAGES, false>(A, B, C, M, N, K, s);
  if (out_dtype == 1)
    return (int)launch_typed<BM, BN, BK, WARPS_M, WARPS_N, STAGES, true>(A, B, C, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One exported entry per tile: clibd_tiled_gemm_<name>(A, B, C, M, N, K,
// out_dtype, stream), A [M, K] and B [K, N] bf16 row-major, C [M, N] fp32
// (out_dtype 0) or bf16 (1), every pointer 16-byte aligned and M, N, K
// multiples of the tile.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).  The names and shapes are mirrored by ops/gemm.py::TILES.
#define CLIBD_GEMM_TILE(NAME, BM, BN, BK, WARPS_M, WARPS_N, STAGES)                            \
  extern "C" int clibd_tiled_gemm_##NAME(const void* A, const void* B, void* C, int M, int N,  \
                                         int K, int out_dtype, void* stream) {                  \
    return launch<BM, BN, BK, WARPS_M, WARPS_N, STAGES>(A, B, C, M, N, K, out_dtype, stream);   \
  }

CLIBD_GEMM_TILE(t64x64x32, 64, 64, 32, 2, 2, 3)          // 4 warps of 32 x 32
CLIBD_GEMM_TILE(t128x128x32_w4, 128, 128, 32, 2, 2, 4)   // 4 warps of 64 x 64: 128 accumulators a thread
CLIBD_GEMM_TILE(t128x128x32, 128, 128, 32, 2, 4, 4)      // 8 warps of 64 x 32
CLIBD_GEMM_TILE(t128x128x64, 128, 128, 64, 2, 4, 3)      // the same, twice the K depth per stage
CLIBD_GEMM_TILE(t128x256x32, 128, 256, 32, 2, 4, 3)      // 8 warps of 64 x 64
CLIBD_GEMM_TILE(t256x128x32, 256, 128, 32, 4, 2, 3)      // 8 warps of 64 x 64

extern "C" const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
