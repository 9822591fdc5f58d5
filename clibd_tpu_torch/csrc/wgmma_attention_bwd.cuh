// The whole-row attention backward over the fused qkv projection, for
// Hopper (sm_90a): Pb and dS of one (batch, head) kept in shared memory, so
// that S and dP are computed once and every product runs once, on wgmma
// with operands loaded by TMA.  The core of the main path's backward
// (flash_attention_qkv_bwd.cu, its route for N <= 208) and of the
// experiment kernel flash_attention_qkv_bwd_phased.cu (the port of
// tools/exp_flash.py::_phased_bwd_kernel), which both include it.  The
// arithmetic of clibd_tpu/ops/pallas/attention.py::_flash_bwd_kernel:
//   S  = q.k^T (fp32 accumulation) * scale + mask,  P = fp32 softmax(S)
//   Pb = bf16(P);  dO, V, K and Q are read as bf16
//   dV = Pb^T.dO,  dP = dO.V^T                     (fp32 accumulation)
//   dS = bf16(P * (dP - rowsum(P * dP)) * scale)   (the fp32 P)
//   dQ = dS.K,     dK = dS^T.Q                     (fp32 accumulation)
// written into the fused layout (columns h*64, D + h*64, 2D + h*64).
//
// The schedule.  One CTA per (batch, head) of W consumer warpgroups (W = 2,
// up to 255 registers a thread; W = 1 where the head has one 64-row query
// block, N <= 64, so that three CTAs share an SM), thread 0 issuing every
// TMA load:
//  * loads, all issued at the start: K and V of the head as one
//    [16 KT, 64] box each (128-byte swizzle, a 3-D map over qkv [B, N, 3D]:
//    rows past N arrive as zeros), and each 64-row query block's q and dO
//    as [64, 64] boxes into the shared memory where that block's Pb and dS
//    rows will go (the block's own rows are free until its warpgroup writes
//    them), one mbarrier for K/V and one a block;
//  * row phase, a warpgroup a query block (blocks wg, wg + W, ...):
//    S = q.K^T on wgmma (SS, as the forward core's S), the exact softmax in
//    base 2 with P kept in fp32 (rows past N get P = 0), then dP = dO.V^T
//    by the same products, both a whole row of keys in fp32 registers (104
//    + 104 a thread at N=197); rowsum(P * dP), then Pb and dS packed into
//    bf16 registers and stored into the block's rows once the products
//    have read q and dO; dQ = dS.K on wgmma
//    with dS from registers (RS, as the core's P.V) and K MN-major; dQ
//    stored from registers;
//  * a barrier; Q and dO of the head then land by TMA where K and V were;
//  * column phase, a warpgroup a 64-key block: dV = Pb^T.dO and dK =
//    dS^T.Q on wgmma, A transposed (MN-major) from the Pb and dS tiles, B
//    MN-major; dK and dV stored from registers.
// No branch stands inside a sequence of wgmma (a branch there makes ptxas
// put a warpgroup.arrive before every product: C7519): every block runs the
// same products, and rows and keys past N are zeros or get weight 0.  A
// fully masked row (every score finfo(float32).min, clamped to -FLT_MAX in
// the key row) is uniform over its N keys, as in the plain version.
//
// Shared memory.  Pb and dS are stored as A^T of the column phase: 8-query
// groups of [Pb: 16 KT keys | dS: 16 KT keys], each in 32-byte-swizzled
// atoms of 16 keys by 8 queries (desc_sw32_mn: an atom is 16 keys wide, so
// the keys pad to 16 KT, not to a multiple of 64 as the 128-byte swizzle
// would need); at N=197 (KT = 13, 208 keys) 173,056 B, grown to 176,128 so
// that the last query block's q and dO boxes fit below its start.  With
// the K/V (then Q/dO) tiles, 2 x 26,624 B, the key row and the mbarriers:
// 231,488 of the 232,448 B a CTA may have.  N above 208 (MAX_KT) does not
// fit.  The column phase's last key block reads A rows past 16 KT keys (the
// next group's bytes): they only reach output rows past N, which are not
// stored.
//
// What bounds it on an H100: bytes, qkv and dO read and dqkv written once
// (14 B N D), against 10 B H N^2 64 operations (at B=500 H=12 N=197: 0.316
// ms of bytes, 0.119 ms of operations).  Left on the table (PERF.md §6 rows
// 2 and 5c): at N > 64 one CTA an SM and nothing of one (batch, head)
// overlapping the next, so every CTA waits for its first loads and for Q
// and dO after the barrier; the last query block of 64 rows (5 live rows at
// N=197) costs a whole block's products; each product waits for the one
// before; at N=133 one warpgroup takes two of the three query blocks.

#pragma once

#include "wgmma_attention.cuh"

namespace clibd {
namespace wgbwd {

using wgattn::fast_exp2;
using wgattn::LOG2E;

constexpr int MAX_KT = 13;        // 208 keys: the largest N whose Pb and dS fit
constexpr int BOX = 64 * HD * 2;  // a [64, 64] bf16 box
constexpr int BAR_KV = 0, BAR_BLOCK = 1, BAR_COL = 1 + MAX_N / 64, NBARS = BAR_COL + 1;
constexpr int BAR_WG = 1;  // named barriers 1, 2: one a warpgroup

// bytes of an 8-query group of Pb and dS: two rows of 16 KT keys, 8 deep
__host__ __device__ constexpr int group_bytes(int kt) { return kt * 512; }

// the Pb / dS area: 2 KT groups, and at least two boxes past the last query
// block's start (its q and dO land there)
__host__ __device__ constexpr int pbds_bytes(int kt) {
  const int whole = 2 * kt * group_bytes(kt);
  const int last = (16 * kt - 1) / 64 * 8 * group_bytes(kt) + 2 * BOX;
  return ((whole > last ? whole : last) + 1023) / 1024 * 1024;
}

// shared memory of a launch with KT key tiles: 1 KB of alignment slack, Pb
// and dS, the two operand tiles, the key row, the mbarriers
__host__ __device__ constexpr int smem_bytes(int kt) {
  return 1024 + pbds_bytes(kt) + 2 * kt * 16 * HD * 2 + MAX_N * 4 + NBARS * 8;
}

// the consumer warpgroups of a CTA with KT key tiles: one where the head
// has a single 64-row query block (KT <= 4), two otherwise
__host__ __device__ constexpr int warpgroups(int kt) { return kt <= 4 ? 1 : 2; }

// a 64 x 64 fp32 accumulator as bf16 rows row0 + (its rows) below N at dst
// (row stride rs), four bytes a thread and column pair
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, long rs, const float (&acc)[32],
                                          int row0, int N) {
  const int tw = threadIdx.x % 128, lane = tw % 32;
  const int r0 = row0 + (tw / 32) * 16 + lane / 4, r1 = r0 + 8;
  __nv_bfloat16* o0 = dst + (long)r0 * rs + 2 * (lane % 4);
  __nv_bfloat16* o1 = o0 + 8 * rs;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(o0 + i * 8) = __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(o1 + i * 8) =
          __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// One warpgroup's query block qb (rows 64 qb ..): its q and dO boxes at blk
// and blk + BOX, K and V in the operand tiles.
template <int KT>
__device__ __forceinline__ void row_block(unsigned char* pbds, const unsigned char* kt,
                                          const unsigned char* vt, const float* key_row,
                                          uint64_t* bar, __nv_bfloat16* dq, long rs, int qb, int N,
                                          float scale) {
  constexpr int NPAD = KT * 16, GROUP = group_bytes(KT);
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32, t = lane & 3;
  const int wg = threadIdx.x / 128;
  unsigned char* blk = pbds + qb * 8 * GROUP;
  const int r0 = qb * 64 + warp * 16 + lane / 4, r1 = r0 + 8;  // this thread's rows
  mbar_wait(bar, 0);

  // ---- S = q.K^T, the whole row of keys (the forward core's S blocks)
  float p[KT * 8];
  fence_operand(p);
  wgmma_fence();
  const uint64_t qd = desc_sw128(blk);
  wgattn::s_block<KT, 0>(p, qd, desc_sw128(kt));
  wgattn::s_block<KT, 1>(p, qd, desc_sw128(kt + BOX));
  wgattn::s_block<KT, 2>(p, qd, desc_sw128(kt + 2 * BOX));
  wgattn::s_block<KT, 3>(p, qd, desc_sw128(kt + 3 * BOX));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(p);

  // ---- the exact softmax of the thread's two rows, in base 2 (the key row
  // is mask * log2 e, -inf past N); P stays fp32, 0 in rows past N.  Every
  // warp takes it, also one whose rows are all past N
  {
    const float c = scale * LOG2E;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2 * KT; ++i) {
      const float2 a = *reinterpret_cast<const float2*>(key_row + i * 8 + 2 * t);
      p[4 * i] = fmaf(p[4 * i], c, a.x);
      p[4 * i + 1] = fmaf(p[4 * i + 1], c, a.y);
      p[4 * i + 2] = fmaf(p[4 * i + 2], c, a.x);
      p[4 * i + 3] = fmaf(p[4 * i + 3], c, a.y);
      mx0 = fmaxf(mx0, fmaxf(p[4 * i], p[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(p[4 * i + 2], p[4 * i + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * KT; ++i) {
      p[4 * i] = fast_exp2(p[4 * i] - mx0);
      p[4 * i + 1] = fast_exp2(p[4 * i + 1] - mx0);
      p[4 * i + 2] = fast_exp2(p[4 * i + 2] - mx1);
      p[4 * i + 3] = fast_exp2(p[4 * i + 3] - mx1);
      l0 += p[4 * i] + p[4 * i + 1];
      l1 += p[4 * i + 2] + p[4 * i + 3];
    }
    l0 = quad_sum(l0);  // every lane of the quad shuffles, also past N
    l1 = quad_sum(l1);
    const float inv0 = r0 < N ? 1.f / l0 : 0.f, inv1 = r1 < N ? 1.f / l1 : 0.f;
#pragma unroll
    for (int i = 0; i < 2 * KT; ++i) {
      p[4 * i] *= inv0;
      p[4 * i + 1] *= inv0;
      p[4 * i + 2] *= inv1;
      p[4 * i + 3] *= inv1;
    }
  }

  // ---- dP = dO.V^T, the whole row of keys, the same products as S
  float dp[KT * 8];
  fence_operand(dp);
  wgmma_fence();
  const uint64_t od = desc_sw128(blk + BOX);
  wgattn::s_block<KT, 0>(dp, od, desc_sw128(vt));
  wgattn::s_block<KT, 1>(dp, od, desc_sw128(vt + BOX));
  wgattn::s_block<KT, 2>(dp, od, desc_sw128(vt + 2 * BOX));
  wgattn::s_block<KT, 3>(dp, od, desc_sw128(vt + 3 * BOX));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(dp);

  // ---- rowsum(P * dP) of the thread's two rows, then dS and Pb rounded and
  // packed as A (n8 tile i: row r0 in [i/2][2(i%2)], row r1 in [i/2][2(i%2)+1])
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * KT; ++i) {
    d0 += p[4 * i] * dp[4 * i] + p[4 * i + 1] * dp[4 * i + 1];
    d1 += p[4 * i + 2] * dp[4 * i + 2] + p[4 * i + 3] * dp[4 * i + 3];
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  uint32_t ds[KT][4], pb[KT][4];
#pragma unroll
  for (int i = 0; i < 2 * KT; ++i) {
    const int g = 4 * i;
    ds[i / 2][2 * (i % 2)] = pack_bf16x2((p[g] * (dp[g] - d0)) * scale,
                                         (p[g + 1] * (dp[g + 1] - d0)) * scale);
    ds[i / 2][2 * (i % 2) + 1] = pack_bf16x2((p[g + 2] * (dp[g + 2] - d1)) * scale,
                                             (p[g + 3] * (dp[g + 3] - d1)) * scale);
    pb[i / 2][2 * (i % 2)] = pack_bf16x2(p[g], p[g + 1]);
    pb[i / 2][2 * (i % 2) + 1] = pack_bf16x2(p[g + 2], p[g + 3]);
  }
  named_barrier(BAR_WG + wg, 128);  // every warp's products have read q and dO

  // ---- Pb and dS of the rows below NPAD into the block's groups
  const uint32_t kr = lane / 4;  // row within the 8-query group
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r < NPAD) {
      unsigned char* g = pbds + (r / 8) * GROUP;
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) {
        const uint32_t off = (n / 2) * 256 + sw32_offset((n % 2) * 8 + 2 * t, kr);
        *reinterpret_cast<uint32_t*>(g + off) = pb[n / 2][2 * (n % 2) + half];
        *reinterpret_cast<uint32_t*>(g + KT * 256 + off) = ds[n / 2][2 * (n % 2) + half];
      }
    }
  }

  // ---- dQ = dS.K, dS from registers, K MN-major
  float acc[32];
  fence_operand(acc);
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) fence_operand(ds[kc]);
  wgmma_fence();
  const uint64_t kd = desc_sw128_mn(kt);
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) WgmmaRS<64, 1>::mma(acc, ds[kc], desc_add(kd, kc * 2048), kc > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc);
  store_acc(dq, rs, acc, qb * 64, N);
}

// One warpgroup's key block kb (keys 64 kb ..): dV = Pb^T.dO and dK = dS^T.Q
template <int KT>
__device__ __forceinline__ void column_block(const unsigned char* pbds, const unsigned char* qt,
                                             const unsigned char* ot, __nv_bfloat16* dk,
                                             __nv_bfloat16* dv, long rs, int kb, int N) {
  constexpr int GROUP = group_bytes(KT);
  float acc_v[32], acc_k[32];
  fence_operand(acc_v);
  fence_operand(acc_k);
  wgmma_fence();
  const uint64_t pd = desc_sw32_mn(pbds + kb * 1024, 256, GROUP);
  const uint64_t od = desc_sw128_mn(ot), qd = desc_sw128_mn(qt);
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {  // 16 queries: two 8-query groups
    const uint64_t a = desc_add(pd, kc * 2 * GROUP);
    Wgmma<64, 1, 1>::mma(acc_v, a, desc_add(od, kc * 2048), kc > 0);
    Wgmma<64, 1, 1>::mma(acc_k, desc_add(a, KT * 256), desc_add(qd, kc * 2048), kc > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc_v);
  fence_operand(acc_k);
  store_acc(dk, rs, acc_k, kb * 64, N);
  store_acc(dv, rs, acc_v, kb * 64, N);
}

// three CTAs an SM where a CTA is one warpgroup (at most 168 registers a
// thread), one of two warpgroups otherwise (up to 255)
template <int KT>
__global__ void __launch_bounds__(warpgroups(KT) * 128, warpgroups(KT) == 1 ? 3 : 1)
bwd_phased_bf16_kernel(const __grid_constant__ CUtensorMap qkv_rows,
                       const __grid_constant__ CUtensorMap qkv_all,
                       const __grid_constant__ CUtensorMap dout_rows,
                       const __grid_constant__ CUtensorMap dout_all, const float* __restrict__ mask,
                       __nv_bfloat16* __restrict__ dqkv, int N, int H, float scale) {
  constexpr int NPAD = KT * 16, TILE = NPAD * HD * 2, GROUP = group_bytes(KT);
  constexpr int W = warpgroups(KT), THREADS = W * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* pbds = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* tile0 = pbds + pbds_bytes(KT);  // K, then Q
  unsigned char* tile1 = tile0 + TILE;           // V, then dO
  float* key_row = reinterpret_cast<float*>(tile1 + TILE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(key_row + MAX_N);

  const int b = blockIdx.x / H, h = blockIdx.x % H, D = H * HD;
  const long rs = 3L * D;  // dqkv row stride
  const int nblk = (N + 63) / 64;
  __nv_bfloat16* dg = dqkv + (long)b * N * rs + h * HD;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NBARS; ++i) mbar_init(bars + i, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bars + BAR_KV, 2 * TILE);
    tma_load_3d(tile0, &qkv_all, bars + BAR_KV, D + h * HD, 0, b);
    tma_load_3d(tile1, &qkv_all, bars + BAR_KV, 2 * D + h * HD, 0, b);
    for (int qb = 0; qb < nblk; ++qb) {
      uint64_t* bar = bars + BAR_BLOCK + qb;
      mbar_arrive_expect_tx(bar, 2 * BOX);
      tma_load_3d(pbds + qb * 8 * GROUP, &qkv_rows, bar, h * HD, qb * 64, b);
      tma_load_3d(pbds + qb * 8 * GROUP + BOX, &dout_rows, bar, h * HD, qb * 64, b);
    }
  }
  wgattn::key_row(key_row, mask, b, N);
  // rows 64 nblk .. NPAD-1 belong to no query block: zeros, for the column phase
  for (int i = nblk * 8 * GROUP / 16 + threadIdx.x; i < 2 * KT * GROUP / 16; i += THREADS)
    reinterpret_cast<uint4*>(pbds)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // ---- row phase
  const int wg = threadIdx.x / 128;
  mbar_wait(bars + BAR_KV, 0);
  for (int qb = wg; qb < nblk; qb += W)
    row_block<KT>(pbds, tile0, tile1, key_row, bars + BAR_BLOCK + qb, dg, rs, qb, N, scale);
  fence_proxy_async();  // Pb and dS, visible to the column phase's wgmma
  __syncthreads();      // and K and V no longer read

  // ---- column phase: Q and dO where K and V were
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bars + BAR_COL, 2 * TILE);
    tma_load_3d(tile0, &qkv_all, bars + BAR_COL, h * HD, 0, b);
    tma_load_3d(tile1, &dout_all, bars + BAR_COL, h * HD, 0, b);
  }
  mbar_wait(bars + BAR_COL, 0);
  for (int kb = wg; kb < nblk; kb += W)
    column_block<KT>(pbds, tile0, tile1, dg + D, dg + 2 * D, rs, kb, N);
}

template <int KT>
cudaError_t launch(const void* qkv, const void* dout, const float* mask, void* dqkv, int B, int N,
                   int H, cudaStream_t stream) {
  const int D = H * HD;
  CUtensorMap maps[4];
  const uint32_t box[2] = {64, KT * 16};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = encode_bf16_sw128(maps + i, i < 2 ? qkv : dout, N, i < 2 ? 3 * D : D,
                                            box[i % 2], B);
    if (e != cudaSuccess) return e;
  }
  const int smem = smem_bytes(KT);
  cudaError_t e = cudaFuncSetAttribute(bwd_phased_bf16_kernel<KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bwd_phased_bf16_kernel<KT><<<B * H, warpgroups(KT) * 128, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], mask, static_cast<__nv_bfloat16*>(dqkv), N, H,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// the key-tile count of the instance that takes N keys, 0 past MAX_KT
inline int kt_for(int N) { return N < 1 || N > 16 * MAX_KT ? 0 : kt_instance(N); }

// shared memory a launch at N needs, 0 where the kernel does not take N
inline long whole_row_smem_bytes(int N) { return kt_for(N) ? (long)smem_bytes(kt_for(N)) : 0; }

// Launches the whole-row backward (bf16 qkv [B, N, 3*H*64] and dout
// [B, N, H*64] contiguous and 16-byte aligned, mask [B, N] fp32 or null)
// and returns cudaGetLastError(); cudaErrorInvalidValue for shapes it does
// not take (N above 208, or more shared memory than the card gives).
inline cudaError_t launch_whole_row(const void* qkv, const void* dout, const float* mask,
                                    void* dqkv, int B, int N, int H, cudaStream_t stream) {
  const long smem = whole_row_smem_bytes(N);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (B < 1 || H < 1 || smem == 0 || smem > max_smem || (long)B * H > 0x7fffffffL)
    return cudaErrorInvalidValue;
  switch (kt_for(N)) {
    case 2: return launch<2>(qkv, dout, mask, dqkv, B, N, H, stream);
    case 4: return launch<4>(qkv, dout, mask, dqkv, B, N, H, stream);
    case 9: return launch<9>(qkv, dout, mask, dqkv, B, N, H, stream);
    default: return launch<MAX_KT>(qkv, dout, mask, dqkv, B, N, H, stream);
  }
}

}  // namespace wgbwd
}  // namespace clibd
