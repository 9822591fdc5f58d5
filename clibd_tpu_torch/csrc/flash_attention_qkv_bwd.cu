// Flash-attention backward over the fused qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel clibd_tpu/ops/pallas/attention.py::_flash_bwd_kernel.
// From qkv [B, N, 3*H*64] and dO [B, N, H*64] it writes dqkv [B, N, 3*H*64],
// recomputing P on chip, with the TPU kernel's arithmetic:
//   S  = q.k^T (fp32 accumulation) * scale + mask,  P = fp32 softmax(S)
//   Pb = bf16(P);  dO, V, K and Q are read as bf16
//   dV = Pb^T.dO,  dP = dO.V^T                     (fp32 accumulation)
//   dS = bf16(P * (dP - rowsum(P * dP)) * scale)   (the fp32 P)
//   dQ = dS.K,     dK = dS^T.Q                     (fp32 accumulation)
// and the three parts go straight into the fused layout (columns h*64,
// D + h*64, 2D + h*64), as q, k, v and dO are read from it: no head-split
// copy exists in device memory.  A fully masked row (every score
// finfo(float32).min) has a uniform P, as in the plain version; rows and
// keys past N give nothing.  It takes any N >= 1, and the same inputs give
// the same bits: no floating-point atomics, and no two CTAs write the same
// output.
//
// What bounds it on an H100: the bytes are qkv and dO read and dqkv written,
// 14*B*N*D bytes in bf16 (1.06 GB at the ViT shape, B=500 N=197 D=768: 0.32
// ms at 3.35 TB/s); the least tensor-core work is 10*B*H*N^2*64 FLOPs (S,
// dP, dV, dQ, dK once each), N/1.4 FLOPs per byte: 141 at N = 197, below the
// card's ~295 FLOP/byte ridge, so there device memory bounds it; 469 at
// N = 657, where the operations bound it (1.68 ms against 1.05 ms of bytes
// at B=500).  Beside those, the exponentials of P (B*H*N^2 each pass): one
// pass on the whole-row route, three on the key-tiled one.
//
// Design: two routes for bf16, picked by N (route_for, which the wrapper
// reads through clibd_flash_bwd_route), every product on wgmma with its
// operands loaded by TMA (128-byte swizzle, 3-D maps over qkv [B, N, 3D]
// and dO [B, N, D], so rows past N arrive as zeros, never the next batch's):
//  * ROUTE_ROW, N <= 208: the whole row of a (batch, head) on chip
//    (wgmma_attention_bwd.cuh, the core of the phased backward): S and dP
//    once each, the exact softmax in registers, Pb and dS in shared memory,
//    dQ, dV and dK from them -- 5 products and one exp pass, no statistics;
//  * ROUTE_TILED, N > 208 (any N): key-tiled in two kernels, 9 products and
//    three exp passes:
//    - bwd_rows_kernel, one CTA (a warpgroup) per (b, h, 64-row query
//      tile), three CTAs an SM: K/V blocks of 64 keys stream through a ring
//      of SLOTS mbarrier slots (the warp that releases a slot last refills
//      it, as in the forward), twice.  Sweep 1: S = q.K^T and dP = dO.V^T on
//      wgmma (SS form), the online row max m, sum l = sum exp(S - m) and
//      d = sum exp(S - m) dP, rescaled as m rises; it writes the tile's m,
//      1/l and rowsum(P * dP) = d/l ([B*H, tiles, 3, 64] fp32, a scratch the
//      wrapper allocates).  Sweep 2: S and dP again, P and dS as the
//      reference forms them, dQ += dS.K (RS form: dS from registers, K
//      MN-major), dQ stored from registers.  The mask values of a block
//      load a block ahead;
//    - bwd_cols_kernel, key-major, persistent CTAs of one warpgroup (three
//      an SM) walking (b, h, 64-key block) items: K and V of the block as A
//      operands, Q and dO tiles (and their statistics, one bulk copy)
//      streaming through the ring; per query tile S^T = K.Q^T and dP^T =
//      V.dO^T (SS), P^T and dS^T in registers with the row statistics (the
//      same arithmetic, so the same P), then dV += Pb^T.dO and dK +=
//      dS^T.Q (RS form: A from registers, Q and dO MN-major).
//    dQ summed over the key blocks in a fixed order instead (a turn per
//    (b, h, query tile) passed between the column kernel's CTAs, as in
//    FlashAttention-3's deterministic mode: 7 products, two exp passes) ran
//    slower at N=657, B=500: 15.54-15.62 against this route's 9.75-9.82 ms,
//    the fp32 adds and the waits for the turns over half of a column
//    item's time (PERF.md §6).
// No branch stands inside a sequence of wgmma (C7519): the products are the
// same for every block, and rows and keys past N are zeros or get weight 0
// (the additive key term -inf past N, 1/l = 0 for a query row past N).
//  * fp32 inputs (precision checks, not the bf16 main path) take a split into
//    SIMT row and column kernels with S exact in fp32.
// Left on the table (PERF.md §6 row 2): at N > 208 S and dP are computed
// three times (twice in the row kernel, transposed in the column kernel)
// and P exponentiated three times; each warpgroup's chain (wait, S and dP,
// softmax, the next products) leaves the tensor cores idle between its
// steps, as in the forward (clock64 sections: tools/exp_flash_sched.py
// --row2).  Re-reading K/V (Q/dO) from L2 for every tile is not the limit:
// two or three warpgroups a CTA sharing one ring, and a third ring slot,
// ran slower.  The row statistics could come from the forward (its
// log-sum-exp) instead of a pass of their own; the whole-row route runs one
// CTA an SM at N > 64, nothing of one (batch, head) overlapping the next.

#include <float.h>

#include <algorithm>

#include "wgmma_attention_bwd.cuh"

// clock64 sections of the key-tiled kernels (tools/exp_flash_sched.py
// --row2 defines these); nothing without
#ifndef BWD_TICK
#define BWD_PROF_BEGIN
#define BWD_TICK(k)
#define BWD_PROF_END(first)
#endif

namespace {

using namespace clibd;
using wgattn::FusedQkv;
using wgattn::fast_exp2;
using wgattn::LOG2E;

constexpr int BOX = 64 * HD * 2;      // a [64, 64] bf16 box, 8 KB
constexpr int SLOTS = 2;              // ring slots: (K, V) or (Q, dO) box pairs
constexpr float SCALE = 0.125f;       // 1 / sqrt(64)
constexpr float C = LOG2E * SCALE;    // the scale times log2(e)
constexpr int TILE_STATS = 3 * 64;    // floats of a query tile's m, 1/l and rowsum(P * dP)

enum Route : int { ROUTE_ROW = 0, ROUTE_TILED = 1 };

// The bf16 backward's route at N keys: the whole row on chip up to the 208
// keys whose Pb and dS fit, key-tiled with a second sweep for dQ past them
// (tools/exp_flash_sched.py --row2, PERF.md §6)
constexpr int route_for(int N) { return N <= 208 ? ROUTE_ROW : ROUTE_TILED; }

// shared memory of a key-tiled CTA: 1 KB of alignment slack, its resident
// boxes (the row kernel's q and dO, the column kernel's K and V), the
// ring's, the ring's stats slots (the column kernel's), the mbarriers (a
// slot's, then the resident boxes') and the slots' release counters
constexpr int ROW_SMEM = 1024 + (2 + 2 * SLOTS) * BOX + (SLOTS + 1) * 8 + SLOTS * 4;
constexpr int COL_SMEM =
    1024 + (2 + 2 * SLOTS) * BOX + SLOTS * TILE_STATS * 4 + (SLOTS + 1) * 8 + SLOTS * 4;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// the additive term of key k in the base-2 domain of the softmax
// (wgattn::key_row's) from its mask value `raw`: the mask times log2(e), no
// lower than -FLT_MAX, 0 without a mask, -inf past N
__device__ __forceinline__ float key_of(float raw, bool masked, int k, int N) {
  return k >= N ? -INFINITY : masked ? fmaxf(raw * LOG2E, -FLT_MAX) : 0.f;
}

__device__ __forceinline__ float key_term(const float* mrow, int k, int N) {
  return key_of(mrow && k < N ? __ldg(mrow + k) : 0.f, mrow != nullptr, k, N);
}

// ---------------------------------------------------------------------------
// ROUTE_TILED's row kernel: a CTA (one warpgroup) per (b, h, 64-row query
// tile qt), CTAs ordered with the tiles fastest, so a head's CTAs run
// together and share its K and V in L2.  Accumulator layouts are
// hopper_common's Wgmma: the thread's rows r0 and r0 + 8, columns 8c + 2t
// and +1 in s[4c], s[4c+1] (row r0) and s[4c+2], s[4c+3] (row r0 + 8).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128, 3)
bwd_rows_kernel(const __grid_constant__ CUtensorMap qkv_map,
                const __grid_constant__ CUtensorMap dout_map, const float* __restrict__ mask,
                __nv_bfloat16* __restrict__ dqkv, float* __restrict__ stats, int N, int H) {
  BWD_PROF_BEGIN
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qbox = align1024(smem_raw);        // q, then dO
  unsigned char* ring = qbox + 2 * BOX;             // SLOTS x (K, V)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SLOTS * 2 * BOX);  // SLOTS, then q/dO's
  unsigned* released = reinterpret_cast<unsigned*>(full + SLOTS + 1);

  const int nq = (N + 63) / 64;
  const int bh = blockIdx.x / nq, qt = blockIdx.x % nq;
  const int b = bh / H, h = bh % H, D = H * HD;
  const int pairs = 2 * nq;  // key blocks of the two sweeps: pair m is block m % nq
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const FusedQkv io{&qkv_map, nullptr, b, N, D};
  auto refill = [&](int m) {  // K and V of pair m into slot m % SLOTS (one thread)
    uint64_t* bar = full + m % SLOTS;
    unsigned char* dst = ring + (m % SLOTS) * 2 * BOX;
    mbar_arrive_expect_tx(bar, 2 * BOX);
    io.load(dst, bar, 1, h, (m % nq) * 64);
    io.load(dst + BOX, bar, 2, h, (m % nq) * 64);
  };
  // lane 0 of each warp, once its products with pair m have completed: the
  // warp that releases the slot last loads pair m + SLOTS into it
  auto release = [&](int m) {
    if (lane == 0 && atomicInc(released + m % SLOTS, 3) == 3 && m + SLOTS < pairs)
      refill(m + SLOTS);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS + 1; ++s) mbar_init(full + s, 1);
    for (int s = 0; s < SLOTS; ++s) released[s] = 0u;
    fence_barrier_init();
    mbar_arrive_expect_tx(full + SLOTS, 2 * BOX);
    io.load(qbox, full + SLOTS, 0, h, qt * 64);
    tma_load_3d(qbox + BOX, &dout_map, full + SLOTS, h * HD, qt * 64, b);
    for (int m = 0; m < SLOTS && m < pairs; ++m) refill(m);
  }
  __syncthreads();
  BWD_TICK(0)

  const uint64_t qd = desc_sw128(qbox), od = desc_sw128(qbox + BOX);
  const float* mrow = mask ? mask + (long)b * N : nullptr;
  float s[32], dp[32], raw[16];
  // the mask values of pair m's 16 columns of the thread (keys k0(m) + 8c,
  // + 1), loaded a pair ahead: they arrive while the next products run, and
  // nothing reads them before (key_of at their use)
  auto k0 = [&](int m) { return (m % nq) * 64 + 2 * t; };
  auto load_keys = [&](int m) {
    if (m < pairs && mrow) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int k = k0(m) + 8 * (c / 2) + c % 2;
        raw[c] = k < N ? __ldg(mrow + k) : 0.f;
      }
    }
  };
  // S = q.K^T and dP = dO.V^T of pair m
  auto products = [&](int m) {
    const unsigned char* kv = ring + (m % SLOTS) * 2 * BOX;
    mbar_wait(full + m % SLOTS, (m / SLOTS) & 1);
    BWD_TICK(2)
    fence_operand(s);
    fence_operand(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      Wgmma<64, 0>::mma(s, desc_add(qd, ks * 32), desc_add(desc_sw128(kv), ks * 32), ks > 0);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      Wgmma<64, 0>::mma(dp, desc_add(od, ks * 32), desc_add(desc_sw128(kv + BOX), ks * 32), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);
    fence_operand(dp);
    BWD_TICK(3)
  };

  // ---- sweep 1: the online max, sum and sum of exp(S - m) * dP.  Every
  // block holds a key below N with a finite score, so each max is finite
  // and the first block's factor exp2(-inf - max) is 0
  mbar_wait(full + SLOTS, 0);
  BWD_TICK(1)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  load_keys(0);
  for (int m = 0; m < nq; ++m) {
    products(m);
    release(m);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float a0 = key_of(raw[2 * c], mrow, k0(m) + 8 * c, N);
      const float a1 = key_of(raw[2 * c + 1], mrow, k0(m) + 8 * c + 1, N);
      s[4 * c] = fmaf(s[4 * c], C, a0);
      s[4 * c + 1] = fmaf(s[4 * c + 1], C, a1);
      s[4 * c + 2] = fmaf(s[4 * c + 2], C, a0);
      s[4 * c + 3] = fmaf(s[4 * c + 3], C, a1);
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    load_keys(m + 1);
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float al0 = fast_exp2(m0 - mx0), al1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float e0 = 0.f, e1 = 0.f, f0 = 0.f, f1 = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float p00 = fast_exp2(s[4 * c] - mx0), p01 = fast_exp2(s[4 * c + 1] - mx0);
      const float p10 = fast_exp2(s[4 * c + 2] - mx1), p11 = fast_exp2(s[4 * c + 3] - mx1);
      e0 += p00 + p01;
      e1 += p10 + p11;
      f0 += p00 * dp[4 * c] + p01 * dp[4 * c + 1];
      f1 += p10 * dp[4 * c + 2] + p11 * dp[4 * c + 3];
    }
    l0 = fmaf(l0, al0, e0);
    l1 = fmaf(l1, al1, e1);
    d0 = fmaf(d0, al0, f0);
    d1 = fmaf(d1, al1, f1);
    BWD_TICK(4)
  }
  const float il0 = 1.f / quad_sum(l0), il1 = 1.f / quad_sum(l1);
  d0 = quad_sum(d0) * il0;  // rowsum(P * dP)
  d1 = quad_sum(d1) * il1;
  const int rl0 = warp * 16 + lane / 4, rl1 = rl0 + 8;  // the thread's rows in the tile
  if (t == 0) {  // rows past N: m = 0, 1/l = 0, so the column kernel gives them P = 0
    float* st = stats + (size_t)(bh * nq + qt) * TILE_STATS;
    const bool live0 = qt * 64 + rl0 < N, live1 = qt * 64 + rl1 < N;
    st[rl0] = live0 ? m0 : 0.f;
    st[64 + rl0] = live0 ? il0 : 0.f;
    st[128 + rl0] = live0 ? d0 : 0.f;
    st[rl1] = live1 ? m1 : 0.f;
    st[64 + rl1] = live1 ? il1 : 0.f;
    st[128 + rl1] = live1 ? d1 : 0.f;
  }
  BWD_TICK(7)

  // ---- sweep 2: S and dP again, P = exp(S - m) / l and dS as the
  // reference forms them, dQ += dS.K (dS from registers, K MN-major)
  float dq[32];
  for (int m = nq; m < 2 * nq; ++m) {
    products(m);
    uint32_t ds[4][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float a0 = key_of(raw[2 * c], mrow, k0(m) + 8 * c, N);
      const float a1 = key_of(raw[2 * c + 1], mrow, k0(m) + 8 * c + 1, N);
      const float p00 = fast_exp2(fmaf(s[4 * c], C, a0) - m0) * il0;
      const float p01 = fast_exp2(fmaf(s[4 * c + 1], C, a1) - m0) * il0;
      const float p10 = fast_exp2(fmaf(s[4 * c + 2], C, a0) - m1) * il1;
      const float p11 = fast_exp2(fmaf(s[4 * c + 3], C, a1) - m1) * il1;
      ds[c / 2][2 * (c % 2)] = pack_bf16x2((p00 * (dp[4 * c] - d0)) * SCALE,
                                           (p01 * (dp[4 * c + 1] - d0)) * SCALE);
      ds[c / 2][2 * (c % 2) + 1] = pack_bf16x2((p10 * (dp[4 * c + 2] - d1)) * SCALE,
                                               (p11 * (dp[4 * c + 3] - d1)) * SCALE);
    }
    load_keys(m + 1);
    BWD_TICK(5)
    fence_operand(dq);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_operand(ds[kc]);
    wgmma_fence();
    const uint64_t kd = desc_sw128_mn(ring + (m % SLOTS) * 2 * BOX);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      WgmmaRS<64, 1>::mma(dq, ds[kc], desc_add(kd, kc * 2048), m > nq || kc > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dq);
    release(m);
    BWD_TICK(6)
  }
  wgbwd::store_acc(dqkv + (long)b * N * 3 * D + h * HD, 3L * D, dq, qt * 64, N);
  BWD_TICK(7)
  BWD_PROF_END(0)
}

// ---------------------------------------------------------------------------
// ROUTE_TILED's column kernel, key-major: persistent CTAs of one warpgroup
// walking items it = (b * H + h) * tiles + kb, blockIdx.x + k * gridDim.x
// for its k-th item, the 64 keys of block kb.  The ring's pairs are
// numbered through the CTA's items (pair m is query tile m % tiles of its
// item m / tiles).  Accumulator rows are the thread's keys, columns queries.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128, 3)
bwd_cols_kernel(const __grid_constant__ CUtensorMap qkv_map,
                const __grid_constant__ CUtensorMap dout_map, const float* __restrict__ mask,
                __nv_bfloat16* __restrict__ dqkv, const float* __restrict__ stats, int N, int H,
                int items) {
  BWD_PROF_BEGIN
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kbox = align1024(smem_raw);  // the item's K, then V
  unsigned char* vbox = kbox + BOX;
  unsigned char* ring = kbox + 2 * BOX;  // SLOTS x (Q, dO)
  float* ring_stats = reinterpret_cast<float*>(ring + SLOTS * 2 * BOX);  // SLOTS x TILE_STATS
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_stats + SLOTS * TILE_STATS);  // + K/V's
  unsigned* released = reinterpret_cast<unsigned*>(full + SLOTS + 1);

  const int nq = (N + 63) / 64, D = H * HD;
  const long rs = 3L * D;
  const int count = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int pairs = count * nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  auto item = [&](int k) { return (int)blockIdx.x + k * (int)gridDim.x; };
  auto refill = [&](int m) {  // Q, dO and statistics of pair m into slot m % SLOTS
    const int bh = item(m / nq) / nq, qt = m % nq, sl = m % SLOTS;
    uint64_t* bar = full + sl;
    unsigned char* dst = ring + sl * 2 * BOX;
    mbar_arrive_expect_tx(bar, 2 * BOX + TILE_STATS * 4);
    tma_load_3d(dst, &qkv_map, bar, (bh % H) * HD, qt * 64, bh / H);
    tma_load_3d(dst + BOX, &dout_map, bar, (bh % H) * HD, qt * 64, bh / H);
    bulk_load(ring_stats + sl * TILE_STATS, stats + (size_t)(bh * nq + qt) * TILE_STATS,
              TILE_STATS * 4, bar);
  };
  auto load_kv = [&](int k) {  // K and V of item k's key block (thread 0)
    const int it = item(k), bh = it / nq;
    const FusedQkv io{&qkv_map, nullptr, bh / H, N, D};
    mbar_arrive_expect_tx(full + SLOTS, 2 * BOX);
    io.load(kbox, full + SLOTS, 1, bh % H, it % nq * 64);
    io.load(vbox, full + SLOTS, 2, bh % H, it % nq * 64);
  };
  auto release = [&](int m) {
    if (lane == 0 && atomicInc(released + m % SLOTS, 3) == 3 && m + SLOTS < pairs)
      refill(m + SLOTS);
  };
  if (threadIdx.x == 0) {
    for (int sl = 0; sl < SLOTS + 1; ++sl) mbar_init(full + sl, 1);
    for (int sl = 0; sl < SLOTS; ++sl) released[sl] = 0u;
    fence_barrier_init();
    for (int m = 0; m < SLOTS && m < pairs; ++m) refill(m);
    if (count > 0) load_kv(0);
  }
  __syncthreads();

  const int rl0 = warp * 16 + lane / 4, rl1 = rl0 + 8;  // the thread's rows (keys) of the block
  const uint64_t kd = desc_sw128(kbox), vd = desc_sw128(vbox);
  for (int k = 0; k < count; ++k) {
    const int it = item(k), bh = it / nq, kb = it % nq, b = bh / H, h = bh % H;
    const float* mrow = mask ? mask + (long)b * N : nullptr;
    const float ka0 = key_term(mrow, kb * 64 + rl0, N), ka1 = key_term(mrow, kb * 64 + rl1, N);
    mbar_wait(full + SLOTS, k & 1);
    BWD_TICK(0)
    float dv[32], dk[32];
    for (int qt = 0; qt < nq; ++qt) {
      const int m = k * nq + qt, sl = m % SLOTS;
      const unsigned char* qs = ring + sl * 2 * BOX;
      const float* st = ring_stats + sl * TILE_STATS;
      float p[32], dpt[32];
      mbar_wait(full + sl, (m / SLOTS) & 1);
      BWD_TICK(1)
      // ---- S^T = K.Q^T and dP^T = V.dO^T (SS, Q and dO K-major)
      fence_operand(p);
      fence_operand(dpt);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        Wgmma<64, 0>::mma(p, desc_add(kd, ks * 32), desc_add(desc_sw128(qs), ks * 32), ks > 0);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        Wgmma<64, 0>::mma(dpt, desc_add(vd, ks * 32), desc_add(desc_sw128(qs + BOX), ks * 32),
                          ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(p);
      fence_operand(dpt);
      BWD_TICK(2)

      // ---- P^T = exp2(S^T C + key term - m) / l and dS^T, packed as A (n8
      // tile c: row r0 in [c/2][2(c%2)], row r0 + 8 in [c/2][2(c%2)+1])
      uint32_t pb[4][4], ds[4][4];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int q = 8 * c + 2 * t;
        const float2 mq = *reinterpret_cast<const float2*>(st + q);
        const float2 il = *reinterpret_cast<const float2*>(st + 64 + q);
        const float2 dd = *reinterpret_cast<const float2*>(st + 128 + q);
        const float p00 = fast_exp2(fmaf(p[4 * c], C, ka0) - mq.x) * il.x;
        const float p01 = fast_exp2(fmaf(p[4 * c + 1], C, ka0) - mq.y) * il.y;
        const float p10 = fast_exp2(fmaf(p[4 * c + 2], C, ka1) - mq.x) * il.x;
        const float p11 = fast_exp2(fmaf(p[4 * c + 3], C, ka1) - mq.y) * il.y;
        pb[c / 2][2 * (c % 2)] = pack_bf16x2(p00, p01);
        pb[c / 2][2 * (c % 2) + 1] = pack_bf16x2(p10, p11);
        ds[c / 2][2 * (c % 2)] = pack_bf16x2((p00 * (dpt[4 * c] - dd.x)) * SCALE,
                                             (p01 * (dpt[4 * c + 1] - dd.y)) * SCALE);
        ds[c / 2][2 * (c % 2) + 1] = pack_bf16x2((p10 * (dpt[4 * c + 2] - dd.x)) * SCALE,
                                                 (p11 * (dpt[4 * c + 3] - dd.y)) * SCALE);
      }
      BWD_TICK(3)

      // ---- dV += Pb^T.dO, dK += dS^T.Q (RS, dO and Q MN-major)
      fence_operand(dv);
      fence_operand(dk);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        fence_operand(pb[kc]);
        fence_operand(ds[kc]);
      }
      wgmma_fence();
      const uint64_t qm = desc_sw128_mn(qs), om = desc_sw128_mn(qs + BOX);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        WgmmaRS<64, 1>::mma(dv, pb[kc], desc_add(om, kc * 2048), qt > 0 || kc > 0);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        WgmmaRS<64, 1>::mma(dk, ds[kc], desc_add(qm, kc * 2048), qt > 0 || kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dv);
      fence_operand(dk);
      release(m);
      BWD_TICK(4)
    }
    __nv_bfloat16* dg = dqkv + (long)b * N * rs + h * HD;
    wgbwd::store_acc(dg + D, rs, dk, kb * 64, N);
    wgbwd::store_acc(dg + 2 * D, rs, dv, kb * 64, N);
    __syncthreads();  // K and V are no longer read
    if (threadIdx.x == 0 && k + 1 < count) load_kv(k + 1);
    BWD_TICK(5)
  }
  BWD_PROF_END(8)
}

// bytes of the key-tiled route's scratch at (B, N, H): each query tile's
// m, 1/l and rowsum(P * dP)
size_t tiled_scratch_bytes(int B, int N, int H) {
  return (size_t)B * H * ((N + 63) / 64) * TILE_STATS * sizeof(float);
}

// ROUTE_TILED: the row kernel, then the column kernel
cudaError_t launch_tiled(const void* qkv, const void* dout, const float* mask, void* dqkv,
                         void* scratch, int B, int N, int H, cudaStream_t stream) {
  const int D = H * HD, nq = (N + 63) / 64;
  const long tiles = (long)B * H * nq;
  if (tiles > 0x7fffffffL || (long)B * N > 0x7fffffffL) return cudaErrorInvalidValue;
  CUtensorMap qmap, omap;
  cudaError_t e = encode_bf16_sw128(&qmap, qkv, N, 3 * D, 64, B);
  if (e == cudaSuccess) e = encode_bf16_sw128(&omap, dout, N, D, 64, B);
  if (e != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                ROW_SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                COL_SMEM)) != cudaSuccess)
    return e;
  auto* out = static_cast<__nv_bfloat16*>(dqkv);
  auto* stats = static_cast<float*>(scratch);
  bwd_rows_kernel<<<(int)tiles, 128, ROW_SMEM, stream>>>(qmap, omap, mask, out, stats, N, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // the column kernel's grid: as many CTAs as are resident at once
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_cols_kernel, 128,
                                                         COL_SMEM)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = (int)std::min<long>(tiles, (long)per_sm * sms);
  bwd_cols_kernel<<<grid, 128, COL_SMEM, stream>>>(qmap, omap, mask, out, stats, N, H,
                                                   (int)tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: SIMT row and column kernels, S exact in fp32.  Rows (keys) go to
// the 4 warps in turn, 16 each; lane j scores keys (queries) j and j + 32 of
// the streamed tile, and lane d then sums output columns d and d + 32.
// ---------------------------------------------------------------------------
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int R = KTILE / WARPS;  // rows (keys) per warp
constexpr int FS = HD + 1;        // row stride of a row-per-lane tile: conflict-free

// row kernel: q rows [64][HD], bf16(dO) rows [64][HD], K tile [64][FS], bf16(V)
// tile [64][FS], the key row, a dS row per warp
constexpr size_t F32_ROW_SMEM = (2 * KTILE * HD + 2 * KTILE * FS + KTILE + WARPS * KTILE) * 4;
// column kernel: K rows [64][HD], bf16(V) rows [64][HD], the keys' mask
// row, Q tile [64][FS], bf16(dO) tile [64][FS], the queries' m, 1/l and
// rowsum(P * dP), a Pb and a dS row per warp
constexpr size_t F32_COL_SMEM =
    (2 * KTILE * HD + KTILE + 2 * KTILE * FS + 3 * KTILE + 2 * WARPS * KTILE) * 4;

__device__ __forceinline__ float dot64(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_rows_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                    const float* __restrict__ mask, float* __restrict__ dqkv,
                    float* __restrict__ stats, int N, int H, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][HD]
  float* Os = Qs + KTILE * HD;    // [64][HD]
  float* Ks = Os + KTILE * HD;    // [64][FS]
  float* Vs = Ks + KTILE * FS;    // [64][FS]
  float* add = Vs + KTILE * FS;   // [64]
  const HeadTile c = head_tile(N, H);
  const int D = H * HD;
  const long rs = 3L * D;
  const float* base = qkv + (long)c.b * N * rs;
  const float* og = dout + (long)c.b * N * D + c.h * HD;
  const float* mrow = mask ? mask + (long)c.b * N : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* dsb = add + KTILE + warp * KTILE;

  for (int idx = threadIdx.x; idx < KTILE * HD; idx += THREADS) {
    const int q = c.r0 + idx / HD, col = idx % HD;
    Qs[idx] = q < N ? base[q * rs + c.h * HD + col] : 0.f;
    Os[idx] = q < N ? bf16_round(og[(long)q * D + col]) : 0.f;
  }
  float m[R], l[R], dd[R], dq0[R], dq1[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = dd[i] = dq0[i] = dq1[i] = 0.f;
  }
  const int tiles = (N + KTILE - 1) / KTILE;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int kt = 0; kt < tiles; ++kt) {
      __syncthreads();  // the previous tile is no longer read
      for (int idx = threadIdx.x; idx < KTILE * HD; idx += THREADS) {
        const int r = idx / HD, col = idx % HD, key = kt * KTILE + r;
        const bool live = key < N;
        Ks[r * FS + col] = live ? base[key * rs + D + c.h * HD + col] : 0.f;
        Vs[r * FS + col] = live ? bf16_round(base[key * rs + 2 * D + c.h * HD + col]) : 0.f;
      }
      issue_mask_tile<THREADS>(add, mrow, kt * KTILE, N);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = warp + i * WARPS;
        if (c.r0 + r >= N) continue;  // the same for the whole warp
        float s[2], dp[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = lane + 32 * jj;
          s[jj] = fmaf(dot64(Qs + r * HD, Ks + j * FS), scale, key_add(add, j, N - kt * KTILE));
          dp[jj] = dot64(Os + r * HD, Vs + j * FS);
        }
        if (sweep == 0) {
          const float mx = fmaxf(m[i], warp_max(fmaxf(s[0], s[1])));
          const float b = exp_base(mx), al = expf(m[i] - b);
          const float e0 = expf(s[0] - b), e1 = expf(s[1] - b);
          l[i] = l[i] * al + warp_sum(e0 + e1);
          dd[i] = dd[i] * al + warp_sum(e0 * dp[0] + e1 * dp[1]);
          m[i] = mx;
        } else {
          if (kt == 0) dd[i] /= l[i];  // rowsum(P * dP) from here on
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float p = expf(s[jj] - m[i]) / l[i];
            dsb[lane + 32 * jj] = bf16_round((p * (dp[jj] - dd[i])) * scale);
          }
          __syncwarp();
#pragma unroll 8
          for (int j = 0; j < KTILE; ++j) {
            dq0[i] = fmaf(dsb[j], bf16_round(Ks[j * FS + lane]), dq0[i]);
            dq1[i] = fmaf(dsb[j], bf16_round(Ks[j * FS + lane + 32]), dq1[i]);
          }
          __syncwarp();
        }
      }
    }
  }
  float* st = stats + ((long)c.b * H + c.h) * 3 * N;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int q = c.r0 + warp + i * WARPS;
    if (q >= N) continue;
    float* dg = dqkv + (long)c.b * N * rs + q * rs + c.h * HD;
    dg[lane] = dq0[i];
    dg[lane + 32] = dq1[i];
    if (lane == 0) {
      st[q] = m[i];
      st[N + q] = 1.f / l[i];
      st[2 * N + q] = dd[i];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_cols_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                    const float* __restrict__ mask, float* __restrict__ dqkv,
                    const float* __restrict__ stats, int N, int H, float scale) {
  extern __shared__ float smem[];
  float* Kr = smem;                // [64][HD] the CTA's keys
  float* Vr = Kr + KTILE * HD;     // [64][HD]
  float* kadd = Vr + KTILE * HD;   // [64]
  float* Qt = kadd + KTILE;        // [64][FS]
  float* Ot = Qt + KTILE * FS;     // [64][FS]
  float* rm = Ot + KTILE * FS;     // [3][64]: m, 1/l, rowsum(P * dP) of the tile's queries
  const HeadTile c = head_tile(N, H);
  const int D = H * HD;
  const long rs = 3L * D;
  const float* base = qkv + (long)c.b * N * rs;
  const float* og = dout + (long)c.b * N * D + c.h * HD;
  const float* st = stats + ((long)c.b * H + c.h) * 3 * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pb = rm + 3 * KTILE + warp * 2 * KTILE;
  float* dsb = pb + KTILE;

  for (int idx = threadIdx.x; idx < KTILE * HD; idx += THREADS) {
    const int k = c.r0 + idx / HD, col = idx % HD;
    Kr[idx] = k < N ? base[k * rs + D + c.h * HD + col] : 0.f;
    Vr[idx] = k < N ? bf16_round(base[k * rs + 2 * D + c.h * HD + col]) : 0.f;
  }
  issue_mask_tile<THREADS>(kadd, mask ? mask + (long)c.b * N : nullptr, c.r0, N);
  cp_async_commit();
  cp_async_wait<0>();  // the loop's first barrier makes it visible
  float dk0[R], dk1[R], dv0[R], dv1[R];
#pragma unroll
  for (int i = 0; i < R; ++i) dk0[i] = dk1[i] = dv0[i] = dv1[i] = 0.f;
  const int tiles = (N + KTILE - 1) / KTILE;
  for (int qt = 0; qt < tiles; ++qt) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < KTILE * HD; idx += THREADS) {
      const int r = idx / HD, col = idx % HD, q = qt * KTILE + r;
      const bool live = q < N;
      Qt[r * FS + col] = live ? base[q * rs + c.h * HD + col] : 0.f;
      Ot[r * FS + col] = live ? bf16_round(og[(long)q * D + col]) : 0.f;
    }
    for (int j = threadIdx.x; j < KTILE; j += THREADS) {
      const int q = qt * KTILE + j;
      rm[j] = q < N ? st[q] : 0.f;
      rm[KTILE + j] = q < N ? st[N + q] : 1.f;
      rm[2 * KTILE + j] = q < N ? st[2 * N + q] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp + i * WARPS;
      if (c.r0 + r >= N) continue;  // the same for the whole warp
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        const float s = fmaf(dot64(Kr + r * HD, Qt + j * FS), scale, key_add(kadd, r, N - c.r0));
        const float dp = dot64(Vr + r * HD, Ot + j * FS);
        const float p = qt * KTILE + j < N ? expf(s - rm[j]) * rm[KTILE + j] : 0.f;
        pb[j] = bf16_round(p);
        dsb[j] = bf16_round((p * (dp - rm[2 * KTILE + j])) * scale);
      }
      __syncwarp();
#pragma unroll 8
      for (int j = 0; j < KTILE; ++j) {
        dk0[i] = fmaf(dsb[j], bf16_round(Qt[j * FS + lane]), dk0[i]);
        dk1[i] = fmaf(dsb[j], bf16_round(Qt[j * FS + lane + 32]), dk1[i]);
        dv0[i] = fmaf(pb[j], Ot[j * FS + lane], dv0[i]);
        dv1[i] = fmaf(pb[j], Ot[j * FS + lane + 32], dv1[i]);
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int k = c.r0 + warp + i * WARPS;
    if (k >= N) continue;
    float* dg = dqkv + (long)c.b * N * rs + k * rs + c.h * HD;
    dg[D + lane] = dk0[i];
    dg[D + lane + 32] = dk1[i];
    dg[2 * D + lane] = dv0[i];
    dg[2 * D + lane + 32] = dv1[i];
  }
}


}  // namespace

extern "C" {

// The route of the bf16 backward at N keys (ROUTE_ROW 0: the whole row on
// chip; ROUTE_TILED 1: key-tiled, a second sweep for dQ), as route_for
// picks it
int clibd_flash_bwd_route(int N) { return route_for(N); }

// Bytes of the scratch a launch needs: the row statistics of the fp32
// kernels (dtype 0) or of the key-tiled route (dtype 1); 0 for ROUTE_ROW or
// shapes the kernels do not take
long clibd_flash_bwd_scratch_bytes(int B, int N, int H, int dtype, int route) {
  if (B < 1 || N < 1 || H < 1) return 0;
  if (dtype == 0) return (long)B * H * 3 * N * (long)sizeof(float);
  if (dtype != 1 || route != ROUTE_TILED) return 0;
  return (long)tiled_scratch_bytes(B, N, H);
}

// qkv [B, N, 3*H*64] and dout [B, N, H*64] contiguous and 16-byte aligned,
// both bf16 (dtype 1) or both fp32 (dtype 0); mask [B, N] fp32 contiguous
// or null; dqkv [B, N, 3*H*64] of qkv's dtype; scratch of
// clibd_flash_bwd_scratch_bytes(B, N, H, dtype, route) bytes, 256-byte
// aligned.  bf16 runs `route` (clibd_flash_bwd_route's pick, or the other
// to compare: ROUTE_ROW takes N <= 208, ROUTE_TILED any N); fp32 ignores
// it.  Launches on `stream` and returns the first CUDA error (0 = every
// kernel launched).
int clibd_flash_attention_qkv_bwd(const void* qkv, const void* dout, const float* mask, void* dqkv,
                                  void* scratch, int B, int N, int H, int dtype, int route,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (route == ROUTE_ROW) return (int)wgbwd::launch_whole_row(qkv, dout, mask, dqkv, B, N, H, s);
    if (route == ROUTE_TILED)
      return (int)launch_tiled(qkv, dout, mask, dqkv, scratch, B, N, H, s);
    return (int)cudaErrorInvalidValue;
  }
  const long grid = (long)B * H * ((N + KTILE - 1) / KTILE);
  if (dtype != 0 || grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(flash_bwd_rows_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)F32_ROW_SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(flash_bwd_cols_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)F32_COL_SMEM)) != cudaSuccess)
    return (int)e;
  const float scale = 1.0f / sqrtf((float)HD);
  const auto* q = static_cast<const float*>(qkv);
  const auto* o = static_cast<const float*>(dout);
  auto* dq = static_cast<float*>(dqkv);
  auto* stats = static_cast<float*>(scratch);
  flash_bwd_rows_f32_kernel<<<grid, THREADS, F32_ROW_SMEM, s>>>(q, o, mask, dq, stats, N, H, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_cols_f32_kernel<<<grid, THREADS, F32_COL_SMEM, s>>>(q, o, mask, dq, stats, N, H, scale);
  return (int)cudaGetLastError();
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
