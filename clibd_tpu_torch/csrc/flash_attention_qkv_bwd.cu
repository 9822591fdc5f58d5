// Flash-attention backward over the fused qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel clibd_tpu/ops/pallas/attention.py::_flash_bwd_kernel.
// From qkv [B, N, 3*H*64] and dO [B, N, H*64] it writes dqkv [B, N, 3*H*64],
// recomputing P per (batch, head) on chip, with the TPU kernel's arithmetic:
//   S  = q.k^T (fp32 accumulation) * scale + mask,  P = fp32 softmax(S)
//   Pb = bf16(P);  dO, V, K and Q are read as bf16
//   dV = Pb^T.dO,  dP = dO.V^T                     (fp32 accumulation)
//   dS = bf16(P * (dP - rowsum(P * dP)) * scale)   (the fp32 P)
//   dQ = dS.K,     dK = dS^T.Q                     (fp32 accumulation)
// and the three parts go straight into the fused layout (columns h*64,
// D + h*64, 2D + h*64), as q, k, v and dO are read from it: no head-split
// copy exists in device memory.  A fully masked row (every score
// finfo(float32).min) has a uniform P, as in the plain version.
//
// What bounds it on an H100: the bytes are qkv and dO read and dqkv written,
// 14*B*N*D bytes in bf16 (1.06 GB at the ViT shape, B=500 N=197 D=768, so
// 0.32 ms at 3.35 TB/s); the tensor-core work is 8*B*H*N^2*64 FLOPs, N/1.75
// FLOPs per byte (113 at N = 197), below the card's ~295 FLOP/byte ridge.
// So a kernel that keeps S, P, dP and dS on chip is bounded by device memory;
// the plain version writes each of them to device memory and reads it back.
//
// Design (a first, simple one): one CTA per (batch, head), 8 warps.
//  * Q, K, V and dO of the head are staged in shared memory as bf16 (row
//    stride 72 so that fragment loads and ldmatrix hit no bank twice), padded
//    to a multiple of 16 rows with zeros: 4 x 208 x 72 x 2 = 120 KB at N=197,
//    so one CTA per SM.
//  * Row pass, 16 query rows per warp: S for all keys into registers with
//    mma.sync m16n8k16, the exact fp32 row softmax (as the forward kernel),
//    dP 16 keys at a time to form rowsum(P * dP), then dP once more to form
//    dS as bf16 A fragments and dQ += dS.K, K read with ldmatrix.trans.  The
//    per-row max, sum and rowsum(P * dP) go to shared memory.
//  * Column pass, 16 keys per warp: S^T = K.Q^T and dP^T = V.dO^T one query
//    tile at a time, P^T = exp(S^T - max) / sum with the row pass's max and
//    sum (the same arithmetic, so the same P), dS^T as in the row pass, and
//    dV += Pb^T.dO, dK += dS^T.Q with ldmatrix.trans.  No N x N tile is ever
//    stored, in shared memory or in device memory.
//  * fp32 inputs (precision checks, not the bf16 main path) go through a
//    SIMT kernel with the same two passes and S exact in fp32.
// Left on the table: wgmma and TMA, a smaller shared-memory footprint (an
// XOR swizzle instead of the padded stride would fit two CTAs per SM), and
// S and dP are computed twice (row pass and column pass) as well as dP
// twice inside the row pass.

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RS = HD + 8;  // shared-memory row stride of Q, K, V, dO in bf16

// A fragment (16 rows from row0, 64 columns) of a bf16 tile in shared memory
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const __nv_bfloat16* tile,
                                       int row0, int g, int t) {
  const __nv_bfloat16* r0 = tile + (row0 + g) * RS + t * 2;
  const __nv_bfloat16* r1 = r0 + 8 * RS;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    a[ks][0] = ld_u32(r0 + ks * 16);
    a[ks][1] = ld_u32(r1 + ks * 16);
    a[ks][2] = ld_u32(r0 + ks * 16 + 8);
    a[ks][3] = ld_u32(r1 + ks * 16 + 8);
  }
}

// acc (16 x 8) += A (16 x 64) . B^T, where B^T's 8 columns are the rows
// row0 .. row0+7 of a bf16 tile in shared memory
__device__ __forceinline__ void mma_rows(float (&acc)[4], const uint32_t (&a)[HD / 16][4],
                                         const __nv_bfloat16* tile, int row0, int g, int t) {
  const __nv_bfloat16* r = tile + (row0 + g) * RS + t * 2;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) mma_bf16_16816(acc, a[ks], ld_u32(r + ks * 16), ld_u32(r + ks * 16 + 8));
}

// acc (16 x 64) += A (16 x 16) . T[row0 .. row0+15, :] for a bf16 tile T in
// shared memory, read as B fragments with ldmatrix.trans
__device__ __forceinline__ void mma_tile(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int row0, int lane) {
  const __nv_bfloat16* p = tile + (row0 + (lane & 15)) * RS + (lane >> 4) * 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; dt += 2) {
    uint32_t bfr[4];
    ldmatrix_x4_trans(bfr, p + dt * 8);
    mma_bf16_16816(acc[dt], a, bfr[0], bfr[1]);
    mma_bf16_16816(acc[dt + 1], a, bfr[2], bfr[3]);
  }
}

// store a 16 x 64 fp32 accumulator as bf16 rows row0 + g and row0 + g + 8
// (those below N) at dst (row stride rs)
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long rs, const float (&acc)[HD / 8][4],
                                           int row0, int N, int g, int t) {
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + r0 * rs + dt * 8 + t * 2) =
          __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + r1 * rs + dt * 8 + t * 2) =
          __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel.  KT = number of 16-row tiles (Npad = 16*KT).
// ---------------------------------------------------------------------------
template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ mask, __nv_bfloat16* __restrict__ dqkv, int N,
                      int H, float scale) {
  constexpr int NPAD = KT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + NPAD * RS;
  __nv_bfloat16* Vs = Ks + NPAD * RS;
  __nv_bfloat16* Os = Vs + NPAD * RS;  // dO
  float* row_max = reinterpret_cast<float*>(Os + NPAD * RS);
  float* row_sum = row_max + NPAD;
  float* row_dot = row_sum + NPAD;  // rowsum(P * dP)
  float* key_add = row_dot + NPAD;  // per key: the mask, -inf past N

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * HD;
  const long rs = 3L * D;  // qkv and dqkv row stride
  const __nv_bfloat16* qg = qkv + (long)b * N * rs + h * HD;
  const __nv_bfloat16* og = dout + (long)b * N * D + h * HD;
  __nv_bfloat16* dg = dqkv + (long)b * N * rs + h * HD;

  for (int idx = threadIdx.x; idx < NPAD * (HD / 8); idx += THREADS) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q, o = q;
    if (r < N) {
      q = *reinterpret_cast<const uint4*>(qg + r * rs + c);
      k = *reinterpret_cast<const uint4*>(qg + D + r * rs + c);
      v = *reinterpret_cast<const uint4*>(qg + 2 * D + r * rs + c);
      o = *reinterpret_cast<const uint4*>(og + (long)r * D + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * RS + c) = q;
    *reinterpret_cast<uint4*>(Ks + r * RS + c) = k;
    *reinterpret_cast<uint4*>(Vs + r * RS + c) = v;
    *reinterpret_cast<uint4*>(Os + r * RS + c) = o;
  }
  for (int j = threadIdx.x; j < NPAD; j += THREADS)
    key_add[j] = j < N ? (mask ? mask[(long)b * N + j] : 0.f) : -INFINITY;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within the 8-row group
  const int t = lane & 3;   // fragment column pair
  const int tiles = (N + 15) / 16;

  // ---- row pass: dQ, and per row the softmax max and sum and rowsum(P*dP)
  for (int mt = warp; mt < tiles; mt += WARPS) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    float s[2 * KT][4];
    {
      uint32_t qa[HD / 16][4];
      load_a(qa, Qs, mt * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        mma_rows(s[nt], qa, Ks, nt * 8, g, t);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float add = key_add[nt * 8 + t * 2 + j];
        s[nt][j] = fmaf(s[nt][j], scale, add);
        s[nt][2 + j] = fmaf(s[nt][2 + j], scale, add);
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = expf(s[nt][j] - mx0);
        s[nt][2 + j] = expf(s[nt][2 + j] - mx1);
        l0 += s[nt][j];
        l1 += s[nt][2 + j];
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {  // s holds the fp32 P from here on
      s[nt][0] /= l0;
      s[nt][1] /= l0;
      s[nt][2] /= l1;
      s[nt][3] /= l1;
    }

    uint32_t oa[HD / 16][4];  // dO rows, A fragments
    load_a(oa, Os, mt * 16, g, t);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows(dp, oa, Vs, nt * 8, g, t);
      d0 += s[nt][0] * dp[0] + s[nt][1] * dp[1];
      d1 += s[nt][2] * dp[2] + s[nt][3] * dp[3];
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    if (t == 0) {
      row_max[r0] = mx0;
      row_sum[r0] = l0;
      row_dot[r0] = d0;
      row_max[r1] = mx1;
      row_sum[r1] = l1;
      row_dot[r1] = d1;
    }

    float dq[HD / 8][4];
    zero(dq);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kt + half;
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows(dp, oa, Vs, nt * 8, g, t);
        ds[half][0] = (s[nt][0] * (dp[0] - d0)) * scale;
        ds[half][1] = (s[nt][1] * (dp[1] - d0)) * scale;
        ds[half][2] = (s[nt][2] * (dp[2] - d1)) * scale;
        ds[half][3] = (s[nt][3] * (dp[3] - d1)) * scale;
      }
      const uint32_t da[4] = {pack_bf16x2(ds[0][0], ds[0][1]), pack_bf16x2(ds[0][2], ds[0][3]),
                              pack_bf16x2(ds[1][0], ds[1][1]), pack_bf16x2(ds[1][2], ds[1][3])};
      mma_tile(dq, da, Ks, kt * 16, lane);
    }
    store_rows(dg, rs, dq, mt * 16, N, g, t);
  }
  __syncthreads();

  // ---- column pass: dK and dV, 16 keys per warp
  for (int ct = warp; ct < tiles; ct += WARPS) {
    uint32_t ka[HD / 16][4], va[HD / 16][4];
    load_a(ka, Ks, ct * 16, g, t);
    load_a(va, Vs, ct * 16, g, t);
    const float add0 = key_add[ct * 16 + g], add1 = key_add[ct * 16 + g + 8];
    float dk[HD / 8][4], dv[HD / 8][4];
    zero(dk);
    zero(dv);
    for (int qt = 0; qt < tiles; ++qt) {
      float p[2][4], ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows(st, ka, Qs, qt * 16 + half * 8, g, t);   // S^T: keys x queries
        mma_rows(dpt, va, Os, qt * 16 + half * 8, g, t);  // dP^T
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = qt * 16 + half * 8 + t * 2 + j;
          const bool live = q < N;
          const float m = row_max[q], l = row_sum[q], d = row_dot[q];
          const float p0 = live ? expf(fmaf(st[j], scale, add0) - m) / l : 0.f;
          const float p1 = live ? expf(fmaf(st[2 + j], scale, add1) - m) / l : 0.f;
          p[half][j] = p0;
          p[half][2 + j] = p1;
          ds[half][j] = (p0 * (dpt[j] - d)) * scale;
          ds[half][2 + j] = (p1 * (dpt[2 + j] - d)) * scale;
        }
      }
      const uint32_t pa[4] = {pack_bf16x2(p[0][0], p[0][1]), pack_bf16x2(p[0][2], p[0][3]),
                              pack_bf16x2(p[1][0], p[1][1]), pack_bf16x2(p[1][2], p[1][3])};
      const uint32_t da[4] = {pack_bf16x2(ds[0][0], ds[0][1]), pack_bf16x2(ds[0][2], ds[0][3]),
                              pack_bf16x2(ds[1][0], ds[1][1]), pack_bf16x2(ds[1][2], ds[1][3])};
      mma_tile(dv, pa, Os, qt * 16, lane);
      mma_tile(dk, da, Qs, qt * 16, lane);
    }
    store_rows(dg + D, rs, dk, ct * 16, N, g, t);
    store_rows(dg + 2 * D, rs, dv, ct * 16, N, g, t);
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT kernel, S exact in fp32.  Row pass: one warp per query row, lane
// j takes keys j, j+32, ...; column pass: one warp per key, lane q takes
// queries q, q+32, ...; lane d then sums output dims d and d+32.
// ---------------------------------------------------------------------------
constexpr int F32_WARPS = 4;
constexpr int F32_THREADS = F32_WARPS * 32;
constexpr int FS = HD + 1;  // fp32 row stride: conflict-free row-per-lane reads
constexpr int BS = HD + 2;  // bf16 row stride: likewise

__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                     const float* __restrict__ mask, float* __restrict__ dqkv, int N, int H,
                     float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [N][FS]
  float* Ks = Qs + N * FS;          // [N][FS]
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(Ks + N * FS);  // [N][BS] bf16(V)
  __nv_bfloat16* Os = Vs + N * BS;                                     // [N][BS] bf16(dO)
  float* row_max = reinterpret_cast<float*>(Os + N * BS);
  float* row_sum = row_max + N;
  float* row_dot = row_sum + N;
  float* key_add = row_dot + N;
  float* wbuf = key_add + N;  // per warp: two rows of N

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * HD;
  const long rs = 3L * D;
  const float* qg = qkv + (long)b * N * rs + h * HD;
  const float* og = dout + (long)b * N * D + h * HD;
  float* dg = dqkv + (long)b * N * rs + h * HD;

  for (int idx = threadIdx.x; idx < N * HD; idx += F32_THREADS) {
    const int r = idx / HD, c = idx % HD;
    Qs[r * FS + c] = qg[r * rs + c];
    Ks[r * FS + c] = qg[D + r * rs + c];
    Vs[r * BS + c] = __float2bfloat16_rn(qg[2 * D + r * rs + c]);
    Os[r * BS + c] = __float2bfloat16_rn(og[(long)r * D + c]);
  }
  for (int j = threadIdx.x; j < N; j += F32_THREADS) key_add[j] = mask ? mask[(long)b * N + j] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* pbuf = wbuf + warp * 2 * N;
  float* dbuf = pbuf + N;

  for (int r = warp; r < N; r += F32_WARPS) {
    const float* qr = Qs + r * FS;
    const __nv_bfloat16* orow = Os + r * BS;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const float* kr = Ks + j * FS;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) acc = fmaf(qr[d], kr[d], acc);
      const float sv = fmaf(acc, scale, key_add[j]);
      pbuf[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(pbuf[j] - mx);
      pbuf[j] = e;
      l += e;
    }
    l = warp_sum(l);
    float dd = 0.f;
    for (int j = lane; j < N; j += 32) {
      const __nv_bfloat16* vr = Vs + j * BS;
      float dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dp = fmaf(__bfloat162float(orow[d]), __bfloat162float(vr[d]), dp);
      const float p = pbuf[j] / l;
      pbuf[j] = p;
      dbuf[j] = dp;
      dd += p * dp;
    }
    dd = warp_sum(dd);
    for (int j = lane; j < N; j += 32) dbuf[j] = bf16_round((pbuf[j] * (dbuf[j] - dd)) * scale);
    __syncwarp();
    for (int d = lane; d < HD; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(dbuf[j], bf16_round(Ks[j * FS + d]), acc);
      dg[r * rs + d] = acc;
    }
    if (lane == 0) {
      row_max[r] = mx;
      row_sum[r] = l;
      row_dot[r] = dd;
    }
    __syncwarp();
  }
  __syncthreads();

  for (int j = warp; j < N; j += F32_WARPS) {
    const float* kr = Ks + j * FS;
    const __nv_bfloat16* vr = Vs + j * BS;
    const float add = key_add[j];
    for (int q = lane; q < N; q += 32) {
      const float* qr = Qs + q * FS;
      const __nv_bfloat16* orow = Os + q * BS;
      float acc = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        acc = fmaf(qr[d], kr[d], acc);
        dp = fmaf(__bfloat162float(orow[d]), __bfloat162float(vr[d]), dp);
      }
      const float p = expf(fmaf(acc, scale, add) - row_max[q]) / row_sum[q];
      pbuf[q] = bf16_round(p);
      dbuf[q] = bf16_round((p * (dp - row_dot[q])) * scale);
    }
    __syncwarp();
    for (int d = lane; d < HD; d += 32) {
      float dk = 0.f, dv = 0.f;
      for (int q = 0; q < N; ++q) {
        dv = fmaf(pbuf[q], __bfloat162float(Os[q * BS + d]), dv);
        dk = fmaf(dbuf[q], bf16_round(Qs[q * FS + d]), dk);
      }
      dg[D + j * rs + d] = dk;
      dg[2 * D + j * rs + d] = dv;
    }
    __syncwarp();
  }
}

template <int KT>
cudaError_t launch_bf16(const void* qkv, const void* dout, const float* mask, void* dqkv, int B,
                        int N, int H, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)4 * KT * 16 * RS * sizeof(__nv_bfloat16) + 4 * KT * 16 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_bf16_kernel<KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_bf16_kernel<KT><<<B * H, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout), mask,
      static_cast<__nv_bfloat16*>(dqkv), N, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* qkv, const void* dout, const float* mask, void* dqkv, int B,
                       int N, int H, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)N * (2 * FS * sizeof(float) + 2 * BS * sizeof(__nv_bfloat16)) +
                      (size_t)(4 + 2 * F32_WARPS) * N * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_f32_kernel<<<B * H, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout), mask,
      static_cast<float*>(dqkv), N, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*64] and dout [B, N, H*64] contiguous, both bf16 (dtype 1)
// or both fp32 (dtype 0); mask [B, N] fp32 contiguous or null; dqkv
// [B, N, 3*H*64] of qkv's dtype.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int clibd_flash_attention_qkv_bwd(const void* qkv, const void* dout, const float* mask, void* dqkv,
                                  int B, int N, int H, int dtype, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > MAX_N || (long)B * H > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(qkv, dout, mask, dqkv, B, N, H, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (kt_instance(N)) {
    case 2: return (int)launch_bf16<2>(qkv, dout, mask, dqkv, B, N, H, scale, s);
    case 4: return (int)launch_bf16<4>(qkv, dout, mask, dqkv, B, N, H, scale, s);
    case 9: return (int)launch_bf16<9>(qkv, dout, mask, dqkv, B, N, H, scale, s);
    case 13: return (int)launch_bf16<13>(qkv, dout, mask, dqkv, B, N, H, scale, s);
    default: return (int)launch_bf16<16>(qkv, dout, mask, dqkv, B, N, H, scale, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int clibd_flash_attention_max_n(void) { return MAX_N; }

}  // extern "C"
