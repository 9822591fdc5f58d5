// Flash attention over the fused qkv projection with the attention
// out-projection fused in, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// clibd_tpu/ops/pallas/attention.py::_flash_outproj_kernel.  Same function:
// per (batch, head) the attention of flash_attention_qkv.cu (S = q.k^T / 8 in
// fp32 plus the optional [B, N] key mask, the fp32 row softmax, P rounded to
// bf16, V read as bf16, P.V accumulated in fp32), the context rounded to
// bf16, then out = ctx . bf16(W_out) accumulated in fp32 plus the fp32 bias,
// cast to qkv's dtype.  The context never reaches device memory: it lives in
// shared memory between the two phases.  It takes any N >= 1; bf16 takes
// H = 2, 4, 6, 8 and 12 (D = 128 .. 768), fp32 any D that is a multiple of
// 128.
//
// What bounds it on an H100: the bytes are qkv read and out written (8*B*N*D
// bytes in bf16) plus W_out once; the tensor-core work is 4*B*H*N^2*64 FLOPs
// of attention and 2*B*N*D^2 of projection.  At B=500: ViT N=197 606 MB
// (0.181 ms at 3.35 TB/s) against 176 GFLOP (0.178 ms at 989 TFLOP/s);
// BarcodeBERT N=133 409 MB (0.122 ms) against 106 GFLOP (0.107 ms);
// BERT-small N=20 H=8 41 MB (0.012 ms) against 5.6 GFLOP (0.006 ms); the
// overlap tokenizer's N=657 2.02 GB (0.602 ms) against 1.05 TFLOP (1.062
// ms).  So bytes bound the three short shapes, by a hair at N=197, and
// operations N=657.  Unfused, the context costs a [B, N, D] write and read
// (303 MB at ViT) on top.  What the card spends beyond the bound goes to
// W_out: every CTA of 64 query rows streams all of it (1.18 MB at D=768)
// from L2 after its attention.  Scratch variants measured on the card
// (tools/exp_outproj.py, PERF.md §6) found that stream bound neither by its bytes nor by
// the tensor cores but by how its loads are issued and released: one ring
// shared by the warpgroups or by a cluster, and boxes of 32-byte rows, each
// cost more than halving the bytes saved.
//
// Design, bf16 (the main path):
//  * one CTA of 16 warps, four warpgroups, per (batch, 64 query rows), one
//    CTA a SM (96 KB of context tile and 128 KB of rings);
//  * the four warpgroups run apart, each with its own 32 KB ring and its own
//    mbarriers, and meet only at one barrier between the two phases;
//  * attention: warpgroup g takes heads g, g+4, g+8 in turn, its warp w
//    query rows 16*(w%4) .. +15: the forward kernel's 16 attending warps a
//    SM.  Its thread 0 streams the head's K and V in tiles of 64 keys
//    through two stages of its ring by TMA, each tile one box of [64 keys,
//    64] laid out with the 128-byte swizzle, from a 3-D map over qkv
//    [B, N, 3D] (keys past N arrive as zeros), refilling a stage after the
//    warpgroup's named barrier that ends its use; with a head's first tile
//    the head's q rows arrive the same way, into the head's k-slab of the
//    context tile, where each warp reads its fragments by ldmatrix before
//    it writes its context rows over them.  The core is the forward
//    kernel's (flash_common.cuh's online_tile, mma.sync with an online
//    softmax, P rounded to bf16 before the division by the row sum) reading
//    the swizzled tiles, and the key mask straight from device memory;
//  * each warp writes its bf16 context rows straight into the 128-byte-
//    swizzled, K-major layout wgmma reads: head h's [64 x 64] block is
//    k-slab h of the projection's A operand, 8 KB, the [64, D] tile 96 KB at
//    D=768 with no padding; fence.proxy.async, then the CTA's barrier;
//  * projection on wgmma: warpgroup g owns output columns [g*D/4,
//    (g+1)*D/4) (at D = 128 and 384 two and three warpgroups of 64 and 128),
//    m64n192k16 at D=768 (96 fp32 accumulator registers a thread).  B is
//    W_out [D_in, D_out] as it is, MN-major, one k16 step a slot: its
//    thread 0 loads its columns' [16, 64] boxes (128-byte rows, the
//    128-byte swizzle) by TMA into its ring (5 stages of 6 KB at D=768, 8
//    at the others) and refills a stage as soon as the product that read it
//    is done; the first stages load as soon as its own attention is over,
//    while the others still attend.  (W_out^T in K-major boxes of 32-byte
//    rows, with the transpose that needs, was slower end to end);
//  * epilogue: each warpgroup adds the bias in fp32, rounds to bf16, stages
//    its columns swizzled in its own ring and stores them by TMA through a
//    3-D map over out [B, N, D], which drops the rows at or past N.
// A fully masked row (every score finfo(float32).min) comes out as the mean
// of V, projected, as in the forward kernel.  No cluster: a cluster of two
// CTAs sharing W_out's boxes by TMA multicast was slower on the card than
// the four independent rings (tools/exp_outproj.py's `cluster` variant).
//  * fp32 qkv (precision checks, not the bf16 main path) takes the forward
//    kernel's SIMT core with S exact in fp32 (attend_head_f32), one head at
//    a time over 8 warps, into a padded [64, D+8] context tile, then an
//    mma.sync projection with W_out ([in, out], bf16, the context bf16 as
//    in the TPU kernel) streamed in [128, 128] cp.async chunks.
// Left on the table: W_out is read from L2 by every CTA (2.36 GB a call at
// ViT), and with one CTA a SM nothing overlaps one tile's projection with
// another's attention (a persistent CTA with a warpgroup that projects the
// previous tile would); the K/V re-read of every query tile; the dead rows
// of the last query tile multiplied (151 GFLOP of projection for 116 at
// ViT); 2000 CTAs at ViT are 15.2 waves of 132 SMs, the last of 20 CTAs.

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int QROWS = 64;  // query rows per CTA: 4 tiles of 16
// the fp32 kernel's warps and W_out chunks
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 128;    // W_out chunk: k rows
constexpr int NC = 128;    // W_out chunk: output columns (64 per warp)
constexpr int WS = NC + 8; // W_out chunk row stride in bf16: conflict-free ldmatrix

constexpr size_t W_BYTES = 2 * (size_t)KC * WS * 2;  // two W_out chunks

// ---------------------------------------------------------------------------
// Projection: out[q0 + r, :] = ctx[r, :] . W + bias for the CTA's rows below N.
// `wbuf` holds two chunks of KC x WS bf16.
// ---------------------------------------------------------------------------
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float a, float b);

template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void load_w_chunk(__nv_bfloat16* dst, const __nv_bfloat16* w, int kc,
                                             int nc, int D) {
  for (int idx = threadIdx.x; idx < KC * (NC / 8); idx += THREADS) {
    const int r = idx / (NC / 8);
    const int c = (idx % (NC / 8)) * 8;
    cp_async16(dst + r * WS + c, w + (long)(kc * KC + r) * D + nc * NC + c);
  }
}

template <typename OutT>
__device__ void project(const __nv_bfloat16* ctx, __nv_bfloat16* wbuf,
                        const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                        OutT* __restrict__ out, long out_row0, int rows, int D) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % 4;       // 16-row tile
  const int half = warp / 4;     // 64-column half of each chunk
  const int CS = D + 8;
  const int kchunks = D / KC, total = (D / NC) * kchunks;
  float acc[8][4];

  load_w_chunk(wbuf, w, 0, 0, D);
  cp_async_commit();
  for (int i = 0; i < total; ++i) {
    const int nc = i / kchunks, kc = i % kchunks;
    cp_async_wait_all();
    __syncthreads();  // chunk i landed for all; chunk i-1's buffer is free
    if (i + 1 < total)
      load_w_chunk(wbuf + ((i + 1) & 1) * KC * WS, w, (i + 1) % kchunks, (i + 1) / kchunks, D);
    cp_async_commit();
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    const __nv_bfloat16* wb = wbuf + (i & 1) * KC * WS;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      ld_a_frag(a, ctx, CS, mt * 16, kc * KC + ks * 16, g, t);
      mma_kmajor<8>(acc, a, wb, WS, ks * 16, half * 64, lane);
    }
    if (kc == kchunks - 1) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nc * NC + half * 64 + j * 8 + t * 2;
        const float b0 = bias[col], b1 = bias[col + 1];
        if (r0 < rows) store_pair(out + (out_row0 + r0) * D + col, acc[j][0] + b0, acc[j][1] + b1);
        if (r1 < rows) store_pair(out + (out_row0 + r1) * D + col, acc[j][2] + b0, acc[j][3] + b1);
      }
    }
  }
}

// zero the context rows at or past N, so the projection multiplies no stale
// shared memory
__device__ __forceinline__ void zero_dead_rows(__nv_bfloat16* ctx, int rows, int D) {
  const int CS = D + 8;
  for (int idx = threadIdx.x; idx < (QROWS - rows) * (D / 8); idx += THREADS) {
    const int r = rows + idx / (D / 8), c = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(ctx + r * CS + c) = make_uint4(0, 0, 0, 0);
  }
}

// (batch, first query row, live rows) of this CTA
struct Tile {
  int b, q0, rows;
};

__device__ __forceinline__ Tile cta_tile(int N) {
  const int qtiles = (N + QROWS - 1) / QROWS;
  const int q0 = (blockIdx.x % qtiles) * QROWS;
  return {(int)(blockIdx.x / qtiles), q0, min(QROWS, N - q0)};
}

// ---------------------------------------------------------------------------
// fp32: SIMT attention with S exact in fp32, one head at a time, then the
// same bf16 projection.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
outproj_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ out, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = H * HD;
  const int CS = D + 8;
  __nv_bfloat16* ctx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* region = smem_raw + ctx_tile_bytes(D);
  const Tile c = cta_tile(N);
  const long rs = 3L * D;
  const float* base = qkv + (long)c.b * N * rs;
  const float* mrow = mask ? mask + (long)c.b * N : nullptr;
  const int lane = threadIdx.x % 32;

  zero_dead_rows(ctx, c.rows, D);
  for (int h = 0; h < H; ++h)
    attend_head_f32<WARPS>(reinterpret_cast<float*>(region), base, rs, D, h, N, c.q0, mrow, scale,
                           [&](int r, float o0, float o1) {
                             ctx[r * CS + h * HD + lane] = __float2bfloat16_rn(o0);
                             ctx[r * CS + h * HD + lane + 32] = __float2bfloat16_rn(o1);
                           });
  project(ctx, reinterpret_cast<__nv_bfloat16*>(region), w, bias, out, (long)c.b * N + c.q0,
          c.rows, D);
}

// ---------------------------------------------------------------------------
// bf16: four warpgroups, each with its own ring, attend one head at a time,
// then project with wgmma from the swizzled context tile.
// ---------------------------------------------------------------------------
constexpr int BF16_THREADS = 512;           // four warpgroups
constexpr int BOX = 64 * 64 * 2;            // a [64 rows, 64 bf16] swizzled tile, 8 KB
constexpr int SMEM_MAX = 232448;            // a CTA's shared memory on sm_90

template <int D>
struct Layout {
  static constexpr int H = D / HD;
  // warpgroups that project, each owning NW output columns, whole 64-column
  // boxes of them: 2, 4, 3, 4, 4 of 64, 64, 128, 128, 192 at H = 2, 4, 6, 8, 12
  static constexpr int PW = H % 4 == 0 ? 4 : H % 3 == 0 ? 3 : 2;
  static constexpr int NW = D / PW;
  static constexpr int CTX = QROWS * D * 2;              // context tile, then the output tile
  static constexpr int RING = 4 * BOX;                   // a warpgroup's: 2 stages of K and V,
                                                         // then its W_out stages
  static constexpr int W_SLOT = NW * 32;                 // W_out [16, NW]: one k16 step
  static constexpr int W_STAGES = RING / W_SLOT < 8 ? RING / W_SLOT : 8;
  static_assert(NW % 64 == 0 && QROWS * NW * 2 <= RING, "a warpgroup stages whole boxes");
  static constexpr int BARRIERS = 8 * 4 * (2 + W_STAGES);
  static constexpr int SMEM = 1024 + CTX + 4 * RING + BARRIERS;
  static_assert(W_STAGES >= 4, "too few ring stages to keep W_out's loads in flight");
  static_assert(SMEM <= SMEM_MAX, "does not fit");
};

__device__ __forceinline__ void store_bf16x2(unsigned char* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS, 1)
outproj_bf16_kernel(const __grid_constant__ CUtensorMap qkv_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap out_map, const float* __restrict__ mask,
                    const float* __restrict__ bias, int N, float scale) {
  using L = Layout<D>;
  constexpr int H = L::H, PW = L::PW, NW = L::NW, STAGES = L::W_STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles need 1024-byte alignment
  unsigned char* ctx = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / 4, tw = threadIdx.x % 128;
  unsigned char* ring = ctx + L::CTX + wg * L::RING;
  uint64_t* afull = reinterpret_cast<uint64_t*>(ctx + L::CTX + 4 * L::RING) + wg * (2 + STAGES);
  uint64_t* wfull = afull + 2;
  if (tw == 0) {
    for (int s = 0; s < 2 + STAGES; ++s) mbar_init(afull + s, 1);
    fence_barrier_init();
  }
  named_barrier(1 + wg, 128);

  // ---- attention: warpgroup wg takes heads wg, wg + 4, ..., each over the
  // key tiles in order, (head, key tile) `it` in stage it % 2 of its ring
  const int qtiles = (N + QROWS - 1) / QROWS;
  const int b = blockIdx.x / qtiles, q0 = (blockIdx.x % qtiles) * QROWS;
  const int tiles = (N + KTILE - 1) / KTILE;
  const int heads = wg < H ? (H - 1 - wg) / 4 + 1 : 0;
  const int total = heads * tiles;
  const float* mrow = mask ? mask + (long)b * N : nullptr;
  auto issue = [&](int it) {  // K and V of tile `it` into stage it % 2; with a
                              // head's first tile, its q rows into its k-slab
    const int h = wg + 4 * (it / tiles), key0 = it % tiles * KTILE;
    unsigned char* st = ring + (it & 1) * 2 * BOX;
    mbar_arrive_expect_tx(afull + (it & 1), (key0 == 0 ? 3 : 2) * BOX);
    if (key0 == 0) tma_load_3d(ctx + h * BOX, &qkv_map, afull + (it & 1), h * HD, q0, b);
    tma_load_3d(st, &qkv_map, afull + (it & 1), D + h * HD, key0, b);
    tma_load_3d(st + BOX, &qkv_map, afull + (it & 1), 2 * D + h * HD, key0, b);
  };
  if (tw == 0)
    for (int it = 0; it < 2 && it < total; ++it) issue(it);
  OnlineRows st;
  uint32_t qa[HD / 16][4];
  const int row0 = q0 + (warp % 4) * 16;
  const bool live = row0 < N;
  for (int it = 0; it < total; ++it) {
    const int kt = it % tiles, h = wg + 4 * (it / tiles);
    mbar_wait(afull + (it & 1), (it >> 1) & 1);
    if (kt == 0) {  // q of this warp's rows from the slab (zeros past N); the
                    // warp writes its context rows there only after this
      online_init(st);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        ldmatrix_x4(qa[ks], reinterpret_cast<const __nv_bfloat16*>(
                                ctx + h * BOX + sw128_offset((warp % 4) * 16 + (lane & 15),
                                                             ks * 16 + 8 * (lane >> 4))));
    }
    if (live) {
      const unsigned char* kv = ring + (it & 1) * 2 * BOX;
      online_tile(st, qa, reinterpret_cast<const __nv_bfloat16*>(kv),
                  reinterpret_cast<const __nv_bfloat16*>(kv + BOX),
                  mrow ? mrow + kt * KTILE : nullptr, N - kt * KTILE, scale, lane);
    }
    if (kt == tiles - 1) {
      // normalise; rows g and g+8 of the warp into head h's k-slab, swizzled
      const float r0 = live ? 1.f / quad_sum(st.l0) : 0.f, r1 = live ? 1.f / quad_sum(st.l1) : 0.f;
      unsigned char* slab = ctx + h * BOX;
      const int r = (warp % 4) * 16 + g;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        store_bf16x2(slab + sw128_offset(r, dt * 8 + 2 * t), st.o[dt][0] * r0, st.o[dt][1] * r0);
        store_bf16x2(slab + sw128_offset(r + 8, dt * 8 + 2 * t), st.o[dt][2] * r1,
                     st.o[dt][3] * r1);
      }
    }
    named_barrier(1 + wg, 128);  // stage it % 2 is no longer read
    if (tw == 0 && it + 2 < total) issue(it + 2);
  }

  // ---- projection: warpgroup wg computes output columns wg*NW .. +NW,
  // acc[64 x NW] = ctx . W_out[:, wg*NW ..], streaming those columns of
  // W_out through its own ring, one k16 step a slot; its thread 0 refills a
  // stage once the product that read it is done (the product is the
  // warpgroup's, so its completion in warp 0 is its completion).  The first
  // slots load while the other warpgroups still attend.
  auto load = [&](int m) {
    mbar_arrive_expect_tx(wfull + m % STAGES, L::W_SLOT);
    for (int j = 0; j < NW / 64; ++j)  // [16, 64] boxes of 128-byte rows, 2 KB apart
      tma_load_2d(ring + (m % STAGES) * L::W_SLOT + j * 2048, &w_map, wfull + m % STAGES,
                  wg * NW + j * 64, m * 16);
  };
  if (tw == 0 && wg < PW)
    for (int m = 0; m < STAGES; ++m) load(m);
  fence_proxy_async();  // the context stores, visible to wgmma
  __syncthreads();      // every head's k-slab is in the context tile
  if (wg >= PW) return;
  float acc[NW / 2];
  for (int i = 0; i < D / 16; ++i) {
    const int s = i % STAGES;
    mbar_wait(wfull + s, (i / STAGES) & 1);
    wgmma_fence();
    Wgmma<NW, 1>::mma(acc, desc_add(desc_sw128(ctx + (i / 4) * BOX), (i % 4) * 32),
                      desc_sw128_mn(ring + s * L::W_SLOT), i > 0);
    wgmma_commit();
    wgmma_wait<0>();
    if (tw == 0 && i + STAGES < D / 16) load(i + STAGES);
  }
  fence_operand(acc);

  // ---- epilogue: + bias in fp32, bf16, staged swizzled in the warpgroup's
  // own ring (free once its last product is done), stored by TMA, which
  // drops the rows at or past N
  const int r = (tw / 32) * 16 + (tw % 32) / 4, cq = 2 * (tw % 4);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = j * 8 + cq;  // within the warpgroup's columns
    const float b0 = bias[wg * NW + col], b1 = bias[wg * NW + col + 1];
    unsigned char* box = ring + (col / 64) * BOX;
    store_bf16x2(box + sw128_offset(r, col % 64), acc[4 * j] + b0, acc[4 * j + 1] + b1);
    store_bf16x2(box + sw128_offset(r + 8, col % 64), acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (tw == 0) {
    for (int k = 0; k < NW / 64; ++k)
      tma_store_3d(&out_map, ring + k * BOX, wg * NW + k * 64, q0, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int D>
cudaError_t launch_bf16(const void* qkv, const float* mask, const void* w, const float* bias,
                        void* out, int B, int N, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap qkv_map, w_map, out_map;
  cudaError_t e;
  if ((e = encode_bf16_sw128(&qkv_map, qkv, N, 3 * D, KTILE, B)) != cudaSuccess ||
      (e = encode_bf16_sw128(&out_map, out, N, D, QROWS, B)) != cudaSuccess ||
      (e = encode_bf16_sw128(&w_map, w, D, D, 16)) != cudaSuccess)
    return e;
  e = cudaFuncSetAttribute(outproj_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::SMEM);
  if (e != cudaSuccess) return e;
  const long grid = (long)B * ((N + QROWS - 1) / QROWS);
  if (grid > 0x7fffffffL) return cudaErrorInvalidValue;
  outproj_bf16_kernel<D><<<(int)grid, BF16_THREADS, L::SMEM, stream>>>(
      qkv_map, w_map, out_map, mask, bias, N, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// shared memory of a launch, or 0 where the shapes are not taken
size_t smem_bytes(int N, int H, int dtype) {
  const int D = H * HD;
  if (N < 1) return 0;
  if (dtype == 1) {
    switch (H) {
      case 2: return Layout<128>::SMEM;
      case 4: return Layout<256>::SMEM;
      case 6: return Layout<384>::SMEM;
      case 8: return Layout<512>::SMEM;
      case 12: return Layout<768>::SMEM;
      default: return 0;
    }
  }
  if (dtype != 0 || H < 2 || D % KC) return 0;
  const size_t attn = f32_attn_bytes(WARPS);
  return ctx_tile_bytes(D) + (attn > W_BYTES ? attn : W_BYTES);
}

}  // namespace

extern "C" {

// Shared memory a launch at (N, H, dtype) needs, 0 where the kernel does not
// take the shapes (bf16: H not 2, 4, 6, 8 or 12; fp32: D = 64*H not a multiple of
// 128).
long clibd_flash_outproj_smem_bytes(int N, int H, int dtype) {
  return (long)smem_bytes(N, H, dtype);
}

// qkv [B, N, 3*H*64] contiguous, bf16 (dtype 1) or fp32 (dtype 0); mask [B, N]
// fp32 or null; w W_out [H*64 in, H*64 out] bf16; bias [H*64] fp32; out
// [B, N, H*64] of qkv's dtype; every bf16 pointer 16-byte aligned.  Launches
// on `stream` and returns the launch's error (0 = launched): shapes not
// taken, a tensor map that does not encode, too much shared memory.
int clibd_flash_attention_qkv_outproj(const void* qkv, const float* mask, const void* w,
                                      const float* bias, void* out, int B, int N, int H,
                                      int dtype, void* stream) {
  const size_t smem = smem_bytes(N, H, dtype);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (B < 1 || smem == 0 || smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (H) {
      case 2: return (int)launch_bf16<128>(qkv, mask, w, bias, out, B, N, s);
      case 4: return (int)launch_bf16<256>(qkv, mask, w, bias, out, B, N, s);
      case 6: return (int)launch_bf16<384>(qkv, mask, w, bias, out, B, N, s);
      case 8: return (int)launch_bf16<512>(qkv, mask, w, bias, out, B, N, s);
      default: return (int)launch_bf16<768>(qkv, mask, w, bias, out, B, N, s);
    }
  }
  const long grid = (long)B * ((N + QROWS - 1) / QROWS);
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaError_t e = cudaFuncSetAttribute(outproj_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  outproj_f32_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(qkv), mask, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<float*>(out), N, H, scale);
  return (int)cudaGetLastError();
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
