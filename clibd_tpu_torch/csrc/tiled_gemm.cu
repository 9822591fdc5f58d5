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
// MB, 0.0025 ms) edge out the operations (2.15 GFLOP, 0.0022 ms), and 64
// tiles of 128 x 128 leave half the SMs idle: latency, not throughput.
//
// Design.  The TPU tiles (256-1024 rows, tk 512-2048) are VMEM blocks whose
// fp32 accumulator would not fit a CTA's registers here; the tile is a
// template parameter, instantiated a few times and exported by name, so the
// sweep asks the TPU scripts' question (tile shape, out dtype) in Hopper
// terms.  Every tile:
//  * a persistent grid: one CTA a SM (or one a tile, when there are fewer),
//    each walking the output tiles blockIdx.x, + gridDim.x, ... in a grouped
//    order (GROUP_M tile rows at a time, column by column), so the CTAs at
//    work at any moment share their A rows and B columns in L2;
//  * a ring of STAGES slots in shared memory, each one k step of 64: A's
//    [BM, 64] box (K-major) and BN/64 boxes [64 k, 64 n] of B, which is
//    [K, N] row-major and so MN-major (no transpose anywhere), all by TMA
//    with the 128-byte swizzle, with a full and an empty mbarrier a slot;
//  * lane 0 of a producer warp issues the loads, running ahead across tile
//    boundaries, so the next tile's first slots load during this tile's
//    epilogue.  (The ninth warp caps ptxas at 168 registers a thread; the
//    128-accumulator tiles fit in 154-160.  The loads issued by a consumer
//    thread between its products, eight warps, were slower: PERF.md §6);
//  * WGS consumer warpgroups, each BM/WGS rows x BN: per slot four k16 steps
//    of wgmma m64nBNk16 (A desc_sw128, B desc_sw128_mn with the boxes 8 KB
//    apart), one product group kept in flight (wait_group 1), the slot of
//    the step before released once its group is done;
//  * the `_c2` tile: a cluster of two CTAs on neighbouring SMs stacked along
//    M shares B: each CTA loads half of a slot's B boxes by TMA multicast
//    into both, so the L2 serves 32 KB a slot a CTA instead of 48 (a 48 KB
//    slot a 128 x 256 k step, at the H100's published 989 TFLOP/s, is ~11.6
//    TB/s from L2 across 132 SMs); each empty barrier takes the releases of
//    both CTAs' consumers;
//  * the epilogue writes the fp32 accumulators straight from registers
//    (fp32, or rounded to bf16 once), 8 or 4 bytes a thread and row.
// M, N and K must be multiples of the tile (and K of 64), as the TPU grid
// requires.  Deliberately absent: the TPU's `dimension_semantics` (CTAs of
// a CUDA grid are independent by construction) and `pl.dot` against
// `jnp.dot` (one product instruction here).  Left on the table: register
// reallocation between producer and consumers (setmaxnreg, for deeper
// pipelines or 256-wide tiles a warpgroup), the epilogue through shared
// memory and TMA stores overlapped with the next tile's products, split-K
// for grids of fewer tiles than SMs.

#include <cuda_bf16.h>

#include "hopper_common.cuh"

namespace {

using namespace clibd;

constexpr int BK = 64;            // k of a slot: one 128-byte swizzled row of bf16
constexpr int BOX = 64 * 64 * 2;  // a [64, 64] bf16 box of B
constexpr int GROUP_M = 16;       // tile rows of a group in the walk order
constexpr int SMEM_MAX = 232448;  // a CTA's shared memory on sm_90

// A tile of BM x BN outputs for a cluster of CLUSTER CTAs stacked along M,
// each CTA BM / CLUSTER rows in WGS consumer warpgroups, a producer warp,
// a ring of STAGES slots
template <int BM_, int BN_, int CLUSTER_, int WGS_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, CLUSTER = CLUSTER_, WGS = WGS_, STAGES = STAGES_;
  static constexpr int CM = BM / CLUSTER;  // rows of a CTA
  static constexpr int WM = CM / WGS;      // rows of a consumer warpgroup
  static constexpr int MW = WM / 64;       // its m64 products a k16 step
  static constexpr int A_BYTES = CM * BK * 2;
  static constexpr int STAGE = A_BYTES + BK * BN * 2;
  static constexpr int CONSUMERS = WGS * 128;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(WM % 64 == 0 && BN % 64 == 0 && BN <= 256 && CM <= 256, "tile");
  static_assert((CLUSTER == 1 || CLUSTER == 2) && (BN / 64) % CLUSTER == 0, "cluster");
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "ring");
};

// tile t of the grouped order: GROUP_M tile rows at a time, column by
// column within a group
__device__ __forceinline__ void tile_origin(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n;
  const int first = t / per_group * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// The loads of a CTA, in the order its consumers take them: slot n of the
// sequence is one k step of one of its tiles, into stage n % STAGES once
// the consumers (of both CTAs of a cluster) have released slot n - STAGES.
// A's box is the CTA's own; of B's BN/64 boxes, shared by the cluster, CTA r
// loads every CLUSTER-th from r on into both CTAs (multicast).  One thread.
template <class T>
struct Producer {
  const CUtensorMap* amap;
  const CUtensorMap* bmap;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int tiles_m, tiles_n, tiles, kt, rank;
  int tile, k, n;  // the next load: its (cluster's) tile, k step and slot

  __device__ __forceinline__ bool done() const { return tile >= tiles; }

  __device__ __forceinline__ void issue() {
    const int s = n % T::STAGES;
    mbar_wait(empty + s, ((n / T::STAGES) & 1) ^ 1);
    int tm, tn;
    tile_origin(tile, tiles_m, tiles_n, tm, tn);
    unsigned char* dst = ring + s * T::STAGE;
    mbar_arrive_expect_tx(full + s, T::STAGE);
    tma_load_2d(dst, amap, full + s, k * BK, tm * T::BM + rank * T::CM);
#pragma unroll
    for (int j = 0; j < T::BN / 64; ++j) {
      if (T::CLUSTER == 1)
        tma_load_2d(dst + T::A_BYTES + j * BOX, bmap, full + s, tn * T::BN + j * 64, k * BK);
      else if (j % T::CLUSTER == rank)
        tma_load_2d_multicast(dst + T::A_BYTES + j * BOX, bmap, full + s, tn * T::BN + j * 64,
                              k * BK, (1 << T::CLUSTER) - 1);
    }
    ++n;
    if (++k == kt) {
      k = 0;
      tile += gridDim.x / T::CLUSTER;
    }
  }
};

template <class T, bool OUT_BF16>
__global__ void __launch_bounds__(T::THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
            void* __restrict__ C, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled boxes need 1024-byte alignment
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  const int tiles_m = M / T::BM, tiles_n = N / T::BN, kt = K / BK;
  const int tiles = tiles_m * tiles_n;
  const int rank = T::CLUSTER > 1 ? (int)cluster_ctarank() : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, T::WGS * T::CLUSTER);  // a release a consumer warpgroup
    }
    fence_barrier_init();
  }
  if (T::CLUSTER > 1)
    cluster_sync();  // the partner's barriers are ready before any multicast
  else
    __syncthreads();

  const int first = blockIdx.x / T::CLUSTER, step = gridDim.x / T::CLUSTER;
  if (threadIdx.x >= T::CONSUMERS) {
    // the producer warp: its lane 0 issues every load of the CTA
    Producer<T> prod{&amap, &bmap, ring, full, empty, tiles_m, tiles_n, tiles, kt, rank,
                     first, 0, 0};
    if (threadIdx.x == T::CONSUMERS)
      while (!prod.done()) prod.issue();
    __syncwarp();
  } else {
    const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    // slot m's stage is read by this warpgroup's products: one arrival on
    // each CTA's empty barrier of the stage
    auto release = [&](int m) {
      if (tw == 0) {
        mbar_arrive(empty + m % T::STAGES);
        if (T::CLUSTER > 1) mbar_arrive_cluster(empty + m % T::STAGES, rank ^ 1);
      }
    };
    int n = 0;  // the CTA's slot sequence, as the producer's
    for (int tile = first; tile < tiles; tile += step) {
      int tm, tn;
      tile_origin(tile, tiles_m, tiles_n, tm, tn);
      float acc[T::MW][T::BN / 2];
      for (int k = 0; k < kt; ++k, ++n) {
        const int s = n % T::STAGES;
        mbar_wait(full + s, (n / T::STAGES) & 1);
        const unsigned char* st = ring + s * T::STAGE;
        const uint64_t ad = desc_sw128(st + wg * T::WM * 128);
        const uint64_t bd = desc_sw128_mn(st + T::A_BYTES, BOX);
#pragma unroll
        for (int mw = 0; mw < T::MW; ++mw) fence_operand(acc[mw]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
          for (int mw = 0; mw < T::MW; ++mw)
            Wgmma<T::BN, 1>::mma(acc[mw], desc_add(ad, mw * 64 * 128 + ks * 32),
                                 desc_add(bd, ks * 2048), k > 0 || ks > 0);
        wgmma_commit();
#pragma unroll
        for (int mw = 0; mw < T::MW; ++mw) fence_operand(acc[mw]);
        if (k > 0) {
          wgmma_wait<1>();
          release(n - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mw = 0; mw < T::MW; ++mw) fence_operand(acc[mw]);
      release(n - 1);

      // accumulator row 16*warp + lane/4 (and + 8), columns 8j + 2(lane % 4), + 1
      const long r = (long)tm * T::BM + rank * T::CM + wg * T::WM + warp * 16 + lane / 4;
      const long c = (long)tn * T::BN + 2 * (lane % 4);
#pragma unroll
      for (int mw = 0; mw < T::MW; ++mw) {
        const long r0 = r + mw * 64;
#pragma unroll
        for (int j = 0; j < T::BN / 8; ++j) {
          const float* a = acc[mw];
          if (OUT_BF16) {
            __nv_bfloat16* Cb = static_cast<__nv_bfloat16*>(C) + r0 * N + c + 8 * j;
            *reinterpret_cast<__nv_bfloat162*>(Cb) = __floats2bfloat162_rn(a[4 * j], a[4 * j + 1]);
            *reinterpret_cast<__nv_bfloat162*>(Cb + 8L * N) =
                __floats2bfloat162_rn(a[4 * j + 2], a[4 * j + 3]);
          } else {
            float* Cf = static_cast<float*>(C) + r0 * N + c + 8 * j;
            *reinterpret_cast<float2*>(Cf) = make_float2(a[4 * j], a[4 * j + 1]);
            *reinterpret_cast<float2*>(Cf + 8L * N) = make_float2(a[4 * j + 2], a[4 * j + 3]);
          }
        }
      }
    }
  }
  // the partner arrives on this CTA's empty barriers until its last slot:
  // no CTA of a cluster leaves before the other is done
  if (T::CLUSTER > 1) cluster_sync();
}

template <class T, bool OUT_BF16>
cudaError_t launch_typed(const CUtensorMap& amap, const CUtensorMap& bmap, void* C, int M, int N,
                         int K, int sms, cudaStream_t stream) {
  auto kernel = gemm_kernel<T, OUT_BF16>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = T::CLUSTER;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = T::CLUSTER > 1 ? 1 : 0;
  // one CTA a SM, or, in clusters, as many clusters as fit at once: a
  // persistent CTA that had to wait for a free SM would double the time
  int slots = sms / T::CLUSTER;
  if (T::CLUSTER > 1) {
    cfg.gridDim = dim3(slots * T::CLUSTER);
    e = cudaOccupancyMaxActiveClusters(&slots, (const void*)kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (slots < 1) return cudaErrorInvalidConfiguration;
  }
  const int tiles = (M / T::BM) * (N / T::BN);
  cfg.gridDim = dim3((tiles < slots ? tiles : slots) * T::CLUSTER);
  e = cudaLaunchKernelEx(&cfg, kernel, amap, bmap, C, M, N, K);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <class T>
int launch(const void* A, const void* B, void* C, int M, int N, int K, int out_dtype,
           void* stream) {
  if (M < T::BM || N < T::BN || K < BK || M % T::BM || N % T::BN || K % BK ||
      (long)(M / T::BM) * (N / T::BN) > 0x7fffffffL || (out_dtype != 0 && out_dtype != 1) ||
      ((uintptr_t)A | (uintptr_t)B | (uintptr_t)C) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (T::SMEM > max_smem || sms < T::CLUSTER) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  cudaError_t e = encode_bf16_sw128(&amap, A, M, K, T::CM);  // [CM, 64] boxes
  if (e == cudaSuccess) e = encode_bf16_sw128(&bmap, B, K, N, BK);  // [64 k, 64 n] boxes
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_dtype == 0 ? launch_typed<T, false>(amap, bmap, C, M, N, K, sms, s)
                              : launch_typed<T, true>(amap, bmap, C, M, N, K, sms, s));
}

}  // namespace

// One exported entry per tile: clibd_tiled_gemm_<name>(A, B, C, M, N, K,
// out_dtype, stream), A [M, K] and B [K, N] bf16 row-major, C [M, N] fp32
// (out_dtype 0) or bf16 (1), every pointer 16-byte aligned and M, N, K
// multiples of the tile's BM, BN and BK = 64.  Launches on `stream` and
// returns the launch's error (0 = launched).  The names and shapes are
// mirrored by ops/gemm.py::TILES: (BM, BN, BK, warps = 4 * WGS + 1 a CTA,
// STAGES).
#define CLIBD_GEMM_TILE(NAME, BM, BN, BK_, CLUSTER, WGS, STAGES)                                 \
  static_assert(BK_ == BK, "a slot is 64 deep");                                                \
  extern "C" int clibd_tiled_gemm_##NAME(const void* A, const void* B, void* C, int M, int N,   \
                                         int K, int out_dtype, void* stream) {                   \
    return launch<Tile<BM, BN, CLUSTER, WGS, STAGES>>(A, B, C, M, N, K, out_dtype, stream);     \
  }

CLIBD_GEMM_TILE(t64x64x64, 64, 64, 64, 1, 1, 4)        // the small tile: 1 warpgroup of 64 x 64
CLIBD_GEMM_TILE(t128x128x64, 128, 128, 64, 1, 2, 6)    // 2 warpgroups of 64 x 128
CLIBD_GEMM_TILE(t128x256x64, 128, 256, 64, 1, 2, 4)    // 2 of 64 x 256 (128 accumulators)
CLIBD_GEMM_TILE(t256x128x64, 256, 128, 64, 1, 2, 4)    // 2 of 128 x 128 (two m64 products a step)
CLIBD_GEMM_TILE(t256x256x64_c2, 256, 256, 64, 2, 2, 4) // 2 CTAs of 128 x 256 sharing B's boxes

extern "C" const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
