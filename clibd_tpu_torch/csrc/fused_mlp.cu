// Fused transformer MLP, act(x.W1 + b1).W2 + b2, for Hopper (sm_90a).
//
// Replaces the TPU kernel clibd_tpu/ops/pallas/mlp.py::_mlp_kernel.  Same
// arithmetic: h = x.W1 accumulated in fp32, plus the fp32 bias, the
// activation in fp32, h rounded to x's dtype, then h.W2 accumulated in fp32
// over all of F, plus the fp32 bias, cast to x's dtype.  The [R, F]
// intermediate never reaches device memory.
//
// What bounds it on an H100.  4*R*D*F FLOPs (0.93 TFLOP at the ViT shape
// R=500*197, D=768, F=3072: 0.94 ms at 989 TFLOP/s) against x, out and both
// weights once (312 MB in bf16, 0.093 ms at 3.35 TB/s): on paper the tensor
// cores.  But a row block's fp32 accumulator, [rows, D], stays in registers
// across all of F: at D=768, 64 rows take 49,152 of the SM's 65,536
// registers, so 64 rows is the largest block a CTA holds and every 64 rows
// stream both weights (9.4 MB) from L2 through shared memory.  The same
// limit leaves no room for a producer warp beside the two consumer
// warpgroups (nine warps cap a thread at 168 registers; eight allow 255), so
// issuing the loads, the mbarrier traffic of a 16 KB ring slot and the
// bias and activation between the two products sit on the consumers' path,
// beside the products.  Those, not L2 bytes, bound the kernel on the card
// (PERF.md §6).
//
// Design:
//  * one CTA of two consumer warpgroups (256 threads) per 64 rows of x, in
//    clusters of two CTAs on neighbouring SMs;
//  * consumer warpgroup w owns all 64 rows and output columns
//    [w*D/2, (w+1)*D/2): D/4 fp32 accumulator registers a thread (192 at
//    D=768) for the whole kernel;
//  * every operand is K-major with the 128-byte swizzle, so every product is
//    a wgmma.mma_async from shared memory: x [64, D] (one TMA load, resident),
//    W1^T [F, D] and W2^T [D, F] (the wrapper transposes the weights on
//    every call), h [64, 64];
//  * F is walked in chunks of 64.  Per chunk, consumer w computes its 32
//    columns of h = x.W1[:, chunk] (m64n32k16 over D), adds b1 (loaded at
//    the chunk's start), applies the activation (its exponential in the
//    hardware's ex2), rounds to bf16 and writes them, swizzled, into a
//    shared h tile (two, alternating); fence.proxy.async and a named barrier
//    of the two consumers; then acc += h.W2[chunk, its columns] (m64n64k16
//    over the chunk);
//  * the weights come through a ring of 16 KB slots (7 stages at D=768, 9 at
//    512, 11 at 256), each stage with a full and an empty mbarrier.  Per F
//    chunk, D/128 slots of W1^T (both consumers' halves of h) and D/128 of
//    W2^T (a [64, 64] box for each consumer).  A consumer releases a stage
//    once the wgmmas that read it are done (wgmma.wait_group 1: one group
//    stays in flight);
//  * warp 0 is also the producer, all 32 lanes at once: when fewer than
//    REFILL_AHEAD slots are in flight, lane l tests the empty barrier of
//    the l-th next slot, and the run of free stages is loaded together, a
//    slot a lane (one thread loading slot after slot held its whole
//    warpgroup up at every slot);
//  * the cluster shares the weight boxes: CTA r loads box r of every slot
//    with a TMA multicast into both CTAs, so each box is read from L2 once
//    for 128 rows; each full barrier expects the whole slot, and each empty
//    barrier takes the releases of both CTAs' consumers (the remote one by
//    mapa + mbarrier.arrive.shared::cluster).  The grid is rounded up to an
//    even count; a CTA past R loads zeros and stores nothing.  Thread 0
//    waits, before its CTA exits, for the last release of every stage, so
//    no CTA leaves while its partner may still arrive on its barriers;
//  * ragged row tails: TMA fills x's rows past R with zeros, and the output
//    (b2 added in fp32, cast to bf16, staged swizzled in x's shared memory)
//    goes out by TMA stores, which drop rows past R;
//  * fp32 inputs (precision checks, not the bf16 main path) go through a
//    SIMT kernel with the same chunking and fp32 throughout.
// The TPU kernel's f_block divisor clamp is a Mosaic constraint with no
// counterpart here.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper_common.cuh"

namespace {

using namespace clibd;

constexpr int THREADS = 256;     // fp32 kernel
constexpr int FC = 64;           // F chunk

enum Act { GELU_TANH = 0, GELU = 1, QUICK_GELU = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == GELU_TANH) return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (act == GELU) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return v / (1.f + expf(-1.702f * v));
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernel fed by a TMA ring, in clusters of two; D in {256, 512,
// 768}, F a multiple of 64
// ---------------------------------------------------------------------------
constexpr int ROWS = 64;                       // rows of x per CTA: the wgmma M
constexpr int BF16_THREADS = 256;              // two consumer warpgroups
constexpr int CLUSTER = 2;                     // CTAs sharing each weight box
constexpr int BOX_BYTES = 64 * 64 * 2;         // one TMA box, [64 rows, 64 bf16]
constexpr int STAGE_BYTES = 2 * BOX_BYTES;     // one ring slot: a box per consumer
constexpr int SMEM_MAX = 232448;               // a CTA's shared memory on sm_90
constexpr int BARRIER_BYTES = 256;
constexpr int REFILL_AHEAD = 3;                // warp 0 refills below this many slots ahead

template <int D>
struct Layout {
  static constexpr int P = D / 128;            // slots of W1^T, and of W2^T, per chunk
  static constexpr int X_BYTES = ROWS * D * 2; // x tile, then the output tile
  static constexpr int FIXED = 1024 + X_BYTES + 2 * BOX_BYTES + BARRIER_BYTES;
  static constexpr int STAGES = (SMEM_MAX - FIXED) / STAGE_BYTES;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(STAGES >= 3 && 2 * STAGES + 1 <= BARRIER_BYTES / 8, "ring does not fit");
};

// activate() with the hardware's exponential and a fast division, to fp32
// precision: gelu_tanh as v * sigmoid(2u), the same function as
// 0.5 v (1 + tanh u), without its cancellation for negative v.  One
// tanh.approx.f32 instead of the two special-function operations is faster
// but errs by ~2^-11, which moves h's bf16 rounding far more often;
// tools/exp_mlp_activation.py times and checks both (PERF.md §6).
__device__ __forceinline__ float activate_fast(float v, int act) {
  if (act == GELU_TANH)
    return __fdividef(v, 1.f + __expf(-1.5957691216057308f * (v + 0.044715f * v * v * v)));
  if (act == GELU) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  return __fdividef(v, 1.f + __expf(-1.702f * v));
}

__device__ __forceinline__ void store_bf16x2(unsigned char* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

template <int D>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(BF16_THREADS, 1)
mlp_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                const __grid_constant__ CUtensorMap w2map, const __grid_constant__ CUtensorMap omap,
                const float* __restrict__ b1, const float* __restrict__ b2, int R, int F, int act) {
  using L = Layout<D>;
  constexpr int P = L::P;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles need 1024-byte alignment
  unsigned char* xs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* hs = xs + L::X_BYTES;
  unsigned char* ring = hs + 2 * BOX_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* xfull = empty + STAGES;

  const int chunks = F / FC;
  const int slots = 2 * P * chunks;  // ring slots in order: per chunk P of W1^T, then P of W2^T
  const int row0 = blockIdx.x * ROWS;
  const uint32_t rank = cluster_ctarank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * CLUSTER);  // both consumers of both CTAs
    }
    mbar_init(xfull, 1);
    fence_barrier_init();
  }
  cluster_sync();

  // Warp 0 is also the producer, all 32 lanes together: `pf` is the next
  // slot to load; slot m goes to stage m % STAGES once every consumer of
  // the cluster has released slot m - STAGES.  Lane l tests the stage of
  // slot pf + l; the run of free stages from lane 0 on is loaded at once.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int pf = 0;
  auto produce = [&](int n) {  // load what is free, and at least slot n
    for (;;) {
      const int m = pf + lane;
      const int st = m % STAGES;
      const bool ok = m < slots && m < n + STAGES - 1 &&
                      mbar_test(empty + st, ((m / STAGES) & 1) ^ 1);
      const int free = __ffs(~__ballot_sync(0xffffffffu, ok)) - 1;
      if (lane < free) {
        const int c = m / (2 * P), r = m % (2 * P);
        const bool second = r >= P;
        const int p = second ? r - P : r;
        // box `rank` of the slot, multicast into both CTAs: W1^T [F, D]: the
        // chunk's rows, D columns 128p + 64*rank; W2^T [D, F]: consumer
        // rank's rows rank*D/2 + 64p, the chunk's columns
        const int c0 = second ? c * FC : p * 128 + rank * 64;
        const int c1 = second ? rank * (D / 2) + p * 64 : c * FC;
        mbar_arrive_expect_tx(full + st, STAGE_BYTES);
        tma_load_2d_multicast(ring + st * STAGE_BYTES + rank * BOX_BYTES, second ? &w2map : &w1map,
                              full + st, c0, c1, (1 << CLUSTER) - 1);
      }
      pf += free;
      if (pf > n || pf >= slots) return;
      mbar_wait(empty + pf % STAGES, ((pf / STAGES) & 1) ^ 1);  // slot n's stage is still held
    }
  };
  auto refill = [&](int n) {  // before slot n is waited for
    if (warp == 0 && pf - n < REFILL_AHEAD) produce(n);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(xfull, L::X_BYTES);
    for (int b = 0; b < D / 64; ++b) tma_load_2d(xs + b * BOX_BYTES, &xmap, xfull, b * 64, row0);
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int r0 = (t / 32) * 16 + (t % 32) / 4;  // accumulator rows r0 and r0 + 8
  const int cq = 2 * (t % 4);                   // and columns 8j + cq, + 1
  auto release = [&](int st) {
    if (t == 0) {
      mbar_arrive(empty + st);
      mbar_arrive_cluster(empty + st, rank ^ 1);
    }
  };

  float acc[P][32];
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;

  int n = 0, s = 0, prev = 0;  // slot, its stage and phase; the stage of slot n - 1
  uint32_t ph = 0;
  refill(0);
  mbar_wait(xfull, 0);
  for (int c = 0; c < chunks; ++c) {
    // h[:, 32wg .. +32] = x . W1^T[chunk rows 32wg .. +32]^T over D
    float hacc[16];
    float2 bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bias[j] = *reinterpret_cast<const float2*>(b1 + c * FC + wg * 32 + j * 8 + cq);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      refill(n);
      mbar_wait(full + s, ph);
      wgmma_fence();
      const uint64_t ad = desc_sw128(xs + 2 * p * BOX_BYTES);
      const uint64_t bd = desc_sw128(ring + s * STAGE_BYTES + wg * 32 * 128);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        Wgmma<32>::mma(hacc, desc_add(ad, off), desc_add(bd, off), p > 0 || kk > 0);
      }
      wgmma_commit();
      if (p > 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = s;
      ++n;
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    release(prev);
    fence_operand(hacc);

    // bias and activation in fp32, h rounded to bf16 into the swizzled tile
    unsigned char* h = hs + (c & 1) * BOX_BYTES;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wg * 32 + j * 8 + cq;
      store_bf16x2(h + sw128_offset(r0, col), activate_fast(hacc[4 * j] + bias[j].x, act),
                   activate_fast(hacc[4 * j + 1] + bias[j].y, act));
      store_bf16x2(h + sw128_offset(r0 + 8, col), activate_fast(hacc[4 * j + 2] + bias[j].x, act),
                   activate_fast(hacc[4 * j + 3] + bias[j].y, act));
    }
    fence_proxy_async();
    named_barrier(1, BF16_THREADS);

    // acc[:, 64q .. +64] += h . W2^T[rows wg*D/2 + 64q .. +64, chunk]^T
    const uint64_t hd = desc_sw128(h);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      refill(n);
      mbar_wait(full + s, ph);
      wgmma_fence();
      const uint64_t bd = desc_sw128(ring + s * STAGE_BYTES + wg * BOX_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<64>::mma(acc[q], desc_add(hd, kk * 32), desc_add(bd, kk * 32), 1);
      wgmma_commit();
      if (q > 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = s;
      ++n;
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    release(prev);
  }
#pragma unroll
  for (int q = 0; q < P; ++q) fence_operand(acc[q]);

  if (row0 < R) {
    // + b2 in fp32, bf16, staged in x's tile (no longer read), stored by TMA
    // box by box (rows past R dropped)
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int b = wg * P + q;
      unsigned char* box = xs + b * BOX_BYTES;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + cq;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + b * 64 + col);
        store_bf16x2(box + sw128_offset(r0, col), acc[q][4 * j] + bb.x, acc[q][4 * j + 1] + bb.y);
        store_bf16x2(box + sw128_offset(r0 + 8, col), acc[q][4 * j + 2] + bb.x,
                     acc[q][4 * j + 3] + bb.y);
      }
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if (t == 0) {
      for (int q = 0; q < P; ++q) {
        const int b = wg * P + q;
        tma_store_2d(&omap, xs + b * BOX_BYTES, b * 64, row0);
      }
      tma_store_commit();
      tma_store_wait_read();
    }
  }
  if (threadIdx.x == 0) {
    // the partner arrives on this CTA's empty barriers until its last slot:
    // wait for the release of every stage's last slot before the CTA exits
    for (int m = max(0, slots - STAGES); m < slots; ++m)
      mbar_wait(empty + m % STAGES, (m / STAGES) & 1);
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
cudaError_t launch_bf16(const void* x, const void* w1t, const float* b1, const void* w2t,
                        const float* b2, void* out, int R, int F, int act, cudaStream_t stream) {
  CUtensorMap xmap, w1map, w2map, omap;
  cudaError_t e;
  if ((e = encode_bf16_sw128(&xmap, x, R, D, ROWS)) != cudaSuccess ||
      (e = encode_bf16_sw128(&omap, out, R, D, ROWS)) != cudaSuccess ||
      (e = encode_bf16_sw128(&w1map, w1t, F, D, FC)) != cudaSuccess ||
      (e = encode_bf16_sw128(&w2map, w2t, D, F, 64)) != cudaSuccess)
    return e;
  const int smem = Layout<D>::SMEM;
  e = cudaFuncSetAttribute(mlp_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int blocks = ((R + ROWS - 1) / ROWS + CLUSTER - 1) / CLUSTER * CLUSTER;
  mlp_bf16_kernel<D><<<blocks, BF16_THREADS, smem, stream>>>(xmap, w1map, w2map, omap, b1, b2, R,
                                                             F, act);
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

// x [R, D] contiguous, bf16 (dtype 1) or fp32 (dtype 0); b1 [F] and b2 [D]
// fp32; out [R, D] of x's dtype; act 0 gelu_tanh, 1 gelu (erf), 2
// quick_gelu.  The weights, of x's dtype: in bf16 K-major, w1 as W1^T [F, D]
// and w2 as W2^T [D, F], every bf16 pointer 16-byte aligned; in fp32 as they
// are, w1 [D, F] and w2 [F, D].  Launches on `stream` and returns the
// launch's error (0 = launched): a tensor map that does not encode, a
// cluster that cannot be scheduled, too much shared memory.
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
