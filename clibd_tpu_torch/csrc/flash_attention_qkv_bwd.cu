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
// finfo(float32).min) has a uniform P, as in the plain version.  It takes any
// N >= 1, and the same inputs give the same bits: no atomics.
//
// What bounds it on an H100: the bytes are qkv and dO read and dqkv written,
// 14*B*N*D bytes in bf16 (1.06 GB at the ViT shape, B=500 N=197 D=768: 0.32
// ms at 3.35 TB/s); the least tensor-core work is 10*B*H*N^2*64 FLOPs (S,
// dP, dV, dQ, dK once each), N/1.4 FLOPs per byte: 141 at N = 197, below the
// card's ~295 FLOP/byte ridge, so there device memory bounds it; 469 at
// N = 657, where the operations bound it (1.68 ms against 1.05 ms of bytes
// at B=500).
//
// Design: FlashAttention-2's split into a row kernel and a column kernel,
// both key-tiled, so that neither holds a row or a column of the N x N
// problem and neither needs an atomic:
//  * row kernel, one CTA of 4 warps per (batch, head, 64 query rows), each
//    warp 16 rows with their q and dO as A fragments in registers; K and V
//    stream in tiles of 64 keys through a two-stage cp.async ring, twice.
//    Sweep 1 computes S and dP of each tile and keeps an online row max m,
//    row sum l = sum exp(S - m) and d = sum exp(S - m) * dP, rescaled as m
//    rises, so rowsum(P * dP) = d / l at the end; sweep 2 recomputes S and
//    dP, forms P = exp(S - m) / l and dS as the reference does, and
//    accumulates dQ = dS.K in registers (K by ldmatrix.trans).  It writes dQ
//    and the rows' m, 1/l and rowsum(P * dP) ([B, H, 3, N] fp32, a scratch
//    the wrapper allocates);
//  * column kernel, one CTA of 4 warps per (batch, head, 64 keys), each warp
//    16 keys with their K and V as A fragments; Q, dO and the rows' three
//    statistics stream in tiles of 64 queries; per tile it computes S^T and
//    dP^T, P^T = exp(S^T - m) * (1/l) with the row kernel's statistics (the
//    same arithmetic, so the same P), dS^T, and accumulates dV += Pb^T.dO and
//    dK += dS^T.Q in registers.
//  * both bf16 kernels are held to 128 registers a thread
//    (__launch_bounds__(128, 4): four CTAs, 16 warps per SM, at the cost of
//    a few spilled registers), which measured faster than two or three CTAs
//    without spills (PERF.md);
//  * every copy into shared memory, the mask and the statistics included, is
//    a cp.async, so no thread waits on device memory outside the ring's
//    waits; exp is the fast __expf and P multiplies by 1/l: a few fp32 ulps,
//    far below the bf16 roundings of Pb and dS, where the precise expf and
//    division would cost the issue slots that bound these loops.
// Recomputations: S three times and dP three times (sweeps 1 and 2, the
// column kernel), dV, dQ and dK once: 9 products of 2*B*H*N^2*64 FLOPs where
// 5 would do (at N = 657, B=500 each is 0.34 ms at the tensor cores' peak).
// Fewer needs dS of a whole row or column on chip (tools/exp_flash.py's
// phased backward, N <= 208) or atomics for dQ.
//  * fp32 inputs (precision checks, not the bf16 main path) take the same
//    split through SIMT kernels with S exact in fp32.
// Left on the table: wgmma and TMA, the third S and dP, and the K/V (Q/dO)
// re-reads from L2 of every query (key) tile.

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
// row kernel stage: K and V tiles and the key row; column kernel stage: Q and
// dO tiles and the queries' m, 1/l and rowsum(P * dP)
constexpr size_t ROW_STAGE = 2 * TILE_BYTES + KTILE * sizeof(float);
constexpr size_t COL_STAGE = 2 * TILE_BYTES + 3 * KTILE * sizeof(float);

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 4)
flash_bwd_rows_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ mask, __nv_bfloat16* __restrict__ dqkv,
                     float* __restrict__ stats, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const HeadTile c = head_tile(N, H);
  const int D = H * HD;
  const long rs = 3L * D;
  const __nv_bfloat16* base = qkv + (long)c.b * N * rs;
  const float* mrow = mask ? mask + (long)c.b * N : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = c.r0 + warp * 16;
  const bool live = row0 < N;

  auto stage = [&](int i) { return smem_raw + (i & 1) * ROW_STAGE; };
  const int tiles = (N + KTILE - 1) / KTILE;
  auto issue = [&](int i) {  // key tile i % tiles (of sweep i / tiles) into stage i % 2
    const int key0 = (i % tiles) * KTILE;
    __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(stage(i));
    issue_tile<THREADS>(kv, base + D + c.h * HD, rs, key0, N);
    issue_tile<THREADS>(kv + KTILE * TS, base + 2 * D + c.h * HD, rs, key0, N);
    issue_mask_tile<THREADS>(reinterpret_cast<float*>(stage(i) + 2 * TILE_BYTES), mrow, key0, N);
    cp_async_commit();
  };

  uint32_t qa[HD / 16][4], oa[HD / 16][4];  // q and dO rows, A fragments
  load_rows_a(qa, base + c.h * HD, rs, N, row0, g, t);
  load_rows_a(oa, dout + (long)c.b * N * D + c.h * HD, D, N, row0, g, t);
  float m0 = -INFINITY, m1 = -INFINITY;  // row maxima (equal across a quad)
  float l0 = 0.f, l1 = 0.f;              // the lane's share of sum exp(S - m), then 1 / the sum
  float d0 = 0.f, d1 = 0.f;              // ... of sum exp(S - m) * dP, then rowsum(P * dP)
  float dq[HD / 8][4];
  zero(dq);

  issue(0);
  for (int i = 0; i < 2 * tiles; ++i) {
    if (i + 1 < 2 * tiles) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i has landed, for every thread
    if (live) {
      const __nv_bfloat16* Ks = reinterpret_cast<const __nv_bfloat16*>(stage(i));
      const __nv_bfloat16* Vs = Ks + KTILE * TS;
      const float* add = reinterpret_cast<const float*>(stage(i) + 2 * TILE_BYTES);
      const int nvalid = N - (i % tiles) * KTILE;
      if (i < tiles) {  // sweep 1: the online max, sum and sum of exp(S - m) * dP
        float s[KTILE / 8][4], dp[KTILE / 8][4];
        mma_rows_t<KTILE / 8>(s, qa, Ks, 0, lane);
        mma_rows_t<KTILE / 8>(dp, oa, Vs, 0, lane);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int nt = 0; nt < KTILE / 8; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float a = key_add(add, nt * 8 + t * 2 + j, nvalid);
            s[nt][j] = fmaf(s[nt][j], scale, a);
            s[nt][2 + j] = fmaf(s[nt][2 + j], scale, a);
            mx0 = fmaxf(mx0, s[nt][j]);
            mx1 = fmaxf(mx1, s[nt][2 + j]);
          }
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float b0 = exp_base(mx0), b1 = exp_base(mx1);
        const float al0 = __expf(m0 - b0), al1 = __expf(m1 - b1);
        m0 = mx0;
        m1 = mx1;
        l0 *= al0;
        d0 *= al0;
        l1 *= al1;
        d1 *= al1;
#pragma unroll
        for (int nt = 0; nt < KTILE / 8; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float e0 = __expf(s[nt][j] - b0), e1 = __expf(s[nt][2 + j] - b1);
            l0 += e0;
            d0 += e0 * dp[nt][j];
            l1 += e1;
            d1 += e1 * dp[nt][2 + j];
          }
        }
      } else {  // sweep 2: P, dS and dQ += dS.K, 16 keys at a time
        if (i == tiles) {
          l0 = 1.f / quad_sum(l0);
          l1 = 1.f / quad_sum(l1);
          d0 = quad_sum(d0) * l0;
          d1 = quad_sum(d1) * l1;
        }
#pragma unroll
        for (int kc = 0; kc < KTILE / 16; ++kc) {
          float s[2][4], dp[2][4];
          mma_rows_t<2>(s, qa, Ks, kc * 16, lane);
          mma_rows_t<2>(dp, oa, Vs, kc * 16, lane);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float a = key_add(add, kc * 16 + half * 8 + t * 2 + j, nvalid);
              const float p0 = __expf(fmaf(s[half][j], scale, a) - m0) * l0;
              const float p1 = __expf(fmaf(s[half][2 + j], scale, a) - m1) * l1;
              s[half][j] = (p0 * (dp[half][j] - d0)) * scale;
              s[half][2 + j] = (p1 * (dp[half][2 + j] - d1)) * scale;
            }
          }
          uint32_t da[4];
          pack_a(da, s, 0);
          mma_kmajor<HD / 8>(dq, da, Ks, TS, kc * 16, 0, lane);
        }
      }
    }
    __syncthreads();  // stage i % 2 is no longer read
  }
  if (!live) return;
  store_rows(dqkv + (long)c.b * N * rs + c.h * HD, rs, dq, row0, N, g, t);
  if (t == 0) {
    float* st = stats + ((long)c.b * H + c.h) * 3 * N;
    const int r0 = row0 + g, r1 = r0 + 8;
    if (r0 < N) {
      st[r0] = m0;
      st[N + r0] = l0;
      st[2 * N + r0] = d0;
    }
    if (r1 < N) {
      st[r1] = m1;
      st[N + r1] = l1;
      st[2 * N + r1] = d1;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 4)
flash_bwd_cols_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ mask, __nv_bfloat16* __restrict__ dqkv,
                     const float* __restrict__ stats, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const HeadTile c = head_tile(N, H);
  const int D = H * HD;
  const long rs = 3L * D;
  const __nv_bfloat16* base = qkv + (long)c.b * N * rs;
  const __nv_bfloat16* og = dout + (long)c.b * N * D + c.h * HD;
  const float* st = stats + ((long)c.b * H + c.h) * 3 * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = c.r0 + warp * 16;
  const bool live = key0 < N;

  auto stage = [&](int i) { return smem_raw + (i & 1) * COL_STAGE; };
  auto issue = [&](int i) {  // query tile i into stage i % 2
    __nv_bfloat16* qo = reinterpret_cast<__nv_bfloat16*>(stage(i));
    issue_tile<THREADS>(qo, base + c.h * HD, rs, i * KTILE, N);
    issue_tile<THREADS>(qo + KTILE * TS, og, D, i * KTILE, N);
    float* row = reinterpret_cast<float*>(stage(i) + 2 * TILE_BYTES);
    for (int j = threadIdx.x; j < 3 * KTILE; j += THREADS) {  // zero past N
      const int q = i * KTILE + j % KTILE;
      cp_async4_zfill(row + j, st + (j / KTILE) * N + (q < N ? q : 0), q < N);
    }
    cp_async_commit();
  };

  uint32_t ka[HD / 16][4], va[HD / 16][4];  // K and V rows of the warp's keys
  load_rows_a(ka, base + D + c.h * HD, rs, N, key0, g, t);
  load_rows_a(va, base + 2 * D + c.h * HD, rs, N, key0, g, t);
  auto mask_of = [&](int k) { return k < N ? (mask ? mask[(long)c.b * N + k] : 0.f) : -INFINITY; };
  const float add0 = mask_of(key0 + g), add1 = mask_of(key0 + g + 8);
  float dk[HD / 8][4], dv[HD / 8][4];
  zero(dk);
  zero(dv);

  const int tiles = (N + KTILE - 1) / KTILE;
  issue(0);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i has landed, for every thread
    if (live) {
      const __nv_bfloat16* Qs = reinterpret_cast<const __nv_bfloat16*>(stage(i));
      const __nv_bfloat16* Os = Qs + KTILE * TS;
      const float* rm = reinterpret_cast<const float*>(stage(i) + 2 * TILE_BYTES);
#pragma unroll
      for (int qc = 0; qc < KTILE / 16; ++qc) {
        float p[2][4], ds[2][4];
        mma_rows_t<2>(p, ka, Qs, qc * 16, lane);   // S^T: keys x queries
        mma_rows_t<2>(ds, va, Os, qc * 16, lane);  // dP^T
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ql = qc * 16 + half * 8 + t * 2 + j;
            const bool liveq = i * KTILE + ql < N;
            const float m = rm[ql], il = rm[KTILE + ql], d = rm[2 * KTILE + ql];
            const float p0 = liveq ? __expf(fmaf(p[half][j], scale, add0) - m) * il : 0.f;
            const float p1 = liveq ? __expf(fmaf(p[half][2 + j], scale, add1) - m) * il : 0.f;
            p[half][j] = p0;
            p[half][2 + j] = p1;
            ds[half][j] = (p0 * (ds[half][j] - d)) * scale;
            ds[half][2 + j] = (p1 * (ds[half][2 + j] - d)) * scale;
          }
        }
        uint32_t pa[4], da[4];
        pack_a(pa, p, 0);
        pack_a(da, ds, 0);
        mma_kmajor<HD / 8>(dv, pa, Os, TS, qc * 16, 0, lane);
        mma_kmajor<HD / 8>(dk, da, Qs, TS, qc * 16, 0, lane);
      }
    }
    __syncthreads();  // stage i % 2 is no longer read
  }
  if (!live) return;
  __nv_bfloat16* dg = dqkv + (long)c.b * N * rs + c.h * HD;
  store_rows(dg + D, rs, dk, key0, N, g, t);
  store_rows(dg + 2 * D, rs, dv, key0, N, g, t);
}

// ---------------------------------------------------------------------------
// fp32: SIMT kernels with the same split, S exact in fp32.  Rows (keys) go to
// the 4 warps in turn, 16 each; lane j scores keys (queries) j and j + 32 of
// the streamed tile, and lane d then sums output columns d and d + 32.
// ---------------------------------------------------------------------------
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

// qkv [B, N, 3*H*64] and dout [B, N, H*64] contiguous, both bf16 (dtype 1)
// or both fp32 (dtype 0); mask [B, N] fp32 contiguous or null; dqkv
// [B, N, 3*H*64] of qkv's dtype; stats a scratch of 3*B*H*N fp32.  Any N >= 1
// whose grids, B*H*ceil(N/64) CTAs each, fit.  Launches the row kernel, then
// the column kernel, on `stream` and returns the first CUDA error (0 = both
// launched).
int clibd_flash_attention_qkv_bwd(const void* qkv, const void* dout, const float* mask, void* dqkv,
                                  float* stats, int B, int N, int H, int dtype, void* stream) {
  const long grid = (long)B * H * ((N + KTILE - 1) / KTILE);
  if (B < 1 || H < 1 || N < 1 || grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1) {
    const auto* q = static_cast<const __nv_bfloat16*>(qkv);
    const auto* o = static_cast<const __nv_bfloat16*>(dout);
    auto* dq = static_cast<__nv_bfloat16*>(dqkv);
    flash_bwd_rows_bf16_kernel<<<grid, THREADS, 2 * ROW_STAGE, s>>>(q, o, mask, dq, stats, N, H,
                                                                     scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    flash_bwd_cols_bf16_kernel<<<grid, THREADS, 2 * COL_STAGE, s>>>(q, o, mask, dq, stats, N, H,
                                                                     scale);
    return (int)cudaGetLastError();
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if ((e = cudaFuncSetAttribute(flash_bwd_rows_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)F32_ROW_SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(flash_bwd_cols_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)F32_COL_SMEM)) != cudaSuccess)
    return (int)e;
  const auto* q = static_cast<const float*>(qkv);
  const auto* o = static_cast<const float*>(dout);
  auto* dq = static_cast<float*>(dqkv);
  flash_bwd_rows_f32_kernel<<<grid, THREADS, F32_ROW_SMEM, s>>>(q, o, mask, dq, stats, N, H, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_cols_f32_kernel<<<grid, THREADS, F32_COL_SMEM, s>>>(q, o, mask, dq, stats, N, H, scale);
  return (int)cudaGetLastError();
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
