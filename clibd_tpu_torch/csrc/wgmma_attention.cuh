// The wgmma attention core of the experiment kernels
// flash_attention_qkv_phased.cu and flash_attention_qkv_batched.cu and of
// attention_bhnd.cu, for Hopper (sm_90a): one consumer warpgroup attends 64
// query rows of one head over the whole row of keys (N <= MAX_N = 256),
// with the arithmetic of the TPU variants tools/exp_flash.py::_phased_kernel
// and _batched_kernel and tools/exp_attn.py::make_pallas_attn (and of
// flash_attention_qkv_reference): S = q.k^T / 8 in fp32 plus the [B, N] key
// mask (none for attention_bhnd), the exact fp32 row softmax over the whole
// row, P normalised and then rounded to bf16, V read as bf16, P.V
// accumulated in fp32, the context stored in bf16.  Where the boxes come
// from and where the context goes is the layout policy an item loop is
// built with: FusedQkv (qkv [B, N, 3D] in, [B, N, D] out: the phased and
// batched kernels) or HeadSplit (q, k, v and the output [B*H, N, 64]:
// attention_bhnd).
//
// What bounds it on an H100, at the harnesses' B=256 H=12: bytes, q, k, v
// read and the context written once (8*B*N*D bytes: 310 MB at N=197,
// 0.0925 ms at 3.35 TB/s; 209 MB and 0.0625 ms at N=133), against
// 4*B*H*N^2*64 operations (30.5 GFLOP, 0.031 ms at 989 TFLOP/s).  Beside
// those, the exponentials (B*H*N^2: 119 M at N=197, ~0.03 ms at the SFUs'
// 16 a cycle an SM) and the fp32 work around them, and the K/V re-reads
// from L2 (every query tile of a head loads the head's K and V).  Measured
// on the card (PERF.md §6, tools/exp_flash_sched.py) none of these is the
// limit: with every load from one batch element (all from L2), or K and V
// loaded once a head, or no softmax at all, a kernel runs 2%, 5% and 22%
// faster; what remains is the chain of one item -- loads, S, softmax, P.V,
// each waiting on the last -- at three warpgroups a SM.
//
// One item of a warpgroup, (head h, query rows q0 .. q0+63, batch b):
//  1. loads: q [64 x 64], then the head's K and V in blocks of 64 keys, each
//     a [64, 64] box by TMA with the 128-byte swizzle from a 3-D map (over
//     qkv [B, N, 3D], or over each of q, k, v as [B*H, N, 64]), so rows
//     past N arrive as zeros, never the next batch's or head's, into the
//     warpgroup's own ring of SLOTS = 9 boxes (one whole item at N = 256)
//     with one mbarrier a slot.  The ring's boxes are the item sequence's
//     q, K..., V..., q, ... in order; its thread 0 refills a slot as soon
//     as the box that held it is released (q and K after the product S, V
//     after P.V), so the next item's q and K load while this item's softmax
//     runs;
//  2. S = q.K^T on wgmma, SS form (q K-major, the K box K-major: a key's 64
//     dims are contiguous), four k16 steps a block of 64 keys, m64n64k16 or
//     the width the last block has left; the whole row stays in registers,
//     s[8 * KT] (KT = 16-key tiles of the instance, kt_instance: 104 fp32 a
//     thread at N=197, 128 at N=256);
//  3. the softmax in registers: a row lives in the 4 threads of a quad, so a
//     row's max and sum are two shuffles each; the additive key row (the
//     mask, -inf past N, both times log2 e) comes from shared memory, staged
//     once a CTA (key_row), and exp is the SFU's 2^x; a warp whose 16 rows
//     are all past N does no work; P = exp(S - max) * (1 / sum), rounded to
//     bf16 and packed two by two into the A registers of the P.V product
//     (the accumulator layout of two n8 tiles is that of one k16 step of A);
//  4. O = P.V on wgmma, RS form (WgmmaRS: A from registers, V's box
//     MN-major, desc_sw128_mn, each k16 step 16 rows = 2 KB of it), KT
//     steps;
//  5. the bf16 context of the rows below N stored from registers, four bytes
//     a thread and column pair, where the layout puts it.
// No branch stands inside a sequence of wgmma: blocks and k16 steps past N
// read the last loaded box again, their scores are -inf and their P zero
// (with branches there, ptxas put a warpgroup.arrive before every product).
// A fully masked row (every score finfo(float32).min) is uniform over its
// N keys, the mean of V, as in the plain version; keys past N get -inf and
// weight 0, and V's rows past N are zeros.
//
// The schedules around it: attend_items walks one warpgroup's items (heads,
// or (batch, head) slabs); between the products of two warpgroups the
// phased kernel puts Turns, which hands the tensor cores from one warpgroup
// to the next (named barriers), and the batched kernel and attention_bhnd
// nothing (NoTurns).
//
// Left on the table: a warpgroup waits for its own products and loads (no
// second item's S in flight: the registers hold one row of S, and ptxas
// spills 64-224 bytes at its cap of 168 at KT = 13 and 16); the 5 live rows
// of the last query tile at N=197 cost a whole tile's products and loads;
// the context leaves by 4-byte stores (no smem is left for a staging box).
// Tried on the card and slower (PERF.md): persistent CTAs walking many
// query tiles, and each product issued as soon as its own box landed.

#pragma once

#include <float.h>

#include "flash_common.cuh"

namespace clibd {
namespace wgattn {

constexpr int QROWS = 64;                   // query rows of an item
constexpr int BOX = 64 * 64 * 2;            // a [64 rows, 64 bf16] swizzled box, 8 KB
constexpr int MAX_BLOCKS = MAX_N / 64;      // blocks of 64 keys in a row
constexpr int SLOTS = 1 + 2 * MAX_BLOCKS;   // a ring holds one whole item
constexpr int RING = SLOTS * BOX;
constexpr int BAR_WG = 1;                   // named barriers 1.. : one per warpgroup
constexpr int BAR_TURN = 8;                 // 8.. : the phased kernel's turns
constexpr float LOG2E = 1.4426950408889634f;

// shared memory of a CTA of W warpgroups: 1 KB of alignment slack, the
// rings, the key row, the mbarriers
__host__ __device__ constexpr int smem_bytes(int W) {
  return 1024 + W * RING + MAX_N * 4 + W * SLOTS * 8;
}

struct Smem {
  unsigned char* rings;  // W rings, 1024-byte aligned
  float* key_row;        // [MAX_N]: the mask, -inf past N
  uint64_t* bars;        // W * SLOTS
};

template <int W>
__device__ __forceinline__ Smem smem_layout(unsigned char* raw) {
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* key_row = reinterpret_cast<float*>(base + W * RING);
  return {base, key_row, reinterpret_cast<uint64_t*>(key_row + MAX_N)};
}

// the CTA's additive key row, in the base-2 domain of the softmax: mask[b, c]
// * log2(e) (0 without a mask) below N, no lower than -FLT_MAX (a mask of
// finfo(float32).min would overflow to -inf, and a fully masked row must
// stay uniform over its keys, not turn into NaN), and -inf past N.  Every
// thread takes part; a barrier must follow.
__device__ __forceinline__ void key_row(float* row, const float* mask, int b, int N) {
  for (int c = threadIdx.x; c < MAX_N; c += blockDim.x)
    row[c] = c >= N ? -INFINITY : mask ? fmaxf(mask[(long)b * N + c] * LOG2E, -FLT_MAX) : 0.f;
}

// 2^x by the SFU (ex2.approx: a few fp32 ulps, far below P's bf16 rounding)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The phased kernel's order of products: warpgroup wg issues a product
// only in its turn, after warpgroup wg-1 issued its own (wg 0 after W-1 in
// the previous round), so that one warpgroup's softmax runs while the next
// one's products are in flight.  Every warpgroup takes the same number of
// turns; `last` is the index of the final one.
struct Turns {
  int wg, W, turn, last;
  __device__ __forceinline__ void begin() {  // before the first turn: wg 0 may go
    if (W > 1 && wg == W - 1) named_barrier_arrive(BAR_TURN, 256);
  }
  __device__ __forceinline__ void acquire() {
    if (W > 1) named_barrier(BAR_TURN + wg, 256);
  }
  __device__ __forceinline__ void release() {
    if (W > 1 && !(wg == W - 1 && turn == last)) named_barrier_arrive(BAR_TURN + (wg + 1) % W, 256);
    ++turn;
  }
};

// the batched kernel's: warpgroups run free
struct NoTurns {
  __device__ __forceinline__ void acquire() {}
  __device__ __forceinline__ void release() {}
};

// Where an item's boxes come from and where its context goes: `load` puts
// the [64, 64] box of part 0 (q), 1 (K) or 2 (V) of item h at `row` into
// dst, `ctx(h, r)` is the context row r of item h, `stride` the elements
// from one context row to the next, and N the rows of an item.
//
// The fused layout of the phased and batched kernels: one 3-D map over qkv
// [B, N, 3D]; item h is head h of batch b, its q, K and V the columns h*64,
// D + h*64 and 2D + h*64; the context [B, N, D].
struct FusedQkv {
  const CUtensorMap* map;
  __nv_bfloat16* out;
  int b, N, D;
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int part, int h, int row) const {
    tma_load_3d(dst, map, bar, part * D + h * HD, row, b);
  }
  __device__ __forceinline__ __nv_bfloat16* ctx(int h, int r) const {
    return out + ((long)b * N + r) * D + h * HD;
  }
  __device__ __forceinline__ int stride() const { return D; }
};

// The head-split layout of attention_bhnd: q, k and v [B*H, N, 64], one 3-D
// map each; item h is the slab h = b*H + head, the map's third coordinate;
// the context [B*H, N, 64].
struct HeadSplit {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  __nv_bfloat16* out;
  int N;
  __device__ __forceinline__ void load(void* dst, uint64_t* bar, int part, int h, int row) const {
    tma_load_3d(dst, part == 0 ? q : part == 1 ? k : v, bar, 0, row, h);
  }
  __device__ __forceinline__ __nv_bfloat16* ctx(int h, int r) const {
    return out + ((long)h * N + r) * HD;
  }
  __device__ __forceinline__ int stride() const { return HD; }
};

// One warpgroup's items: first, first + step, ... (`items` of them), each of
// query rows q0 .. q0+63, in the layout IO.
template <class IO>
struct ItemLoop {
  IO io;
  unsigned char* ring;
  uint64_t* full;
  const float* key_row;
  int q0, first, step, items;
  float scale;
};

// box m of the warpgroup's sequence into slot m % SLOTS (thread 0 of the
// warpgroup only)
template <class IO>
__device__ __forceinline__ void issue_box(const ItemLoop<IO>& L, int m, int nblk) {
  const int per = 1 + 2 * nblk, k = m % per;
  const int h = L.first + m / per * L.step;
  uint64_t* bar = L.full + m % SLOTS;
  unsigned char* dst = L.ring + (m % SLOTS) * BOX;
  mbar_arrive_expect_tx(bar, BOX);
  if (k == 0)
    L.io.load(dst, bar, 0, h, L.q0);
  else if (k <= nblk)
    L.io.load(dst, bar, 1, h, (k - 1) * 64);
  else
    L.io.load(dst, bar, 2, h, (k - 1 - nblk) * 64);
}

template <class IO>
__device__ __forceinline__ void wait_box(const ItemLoop<IO>& L, int m) {
  mbar_wait(L.full + m % SLOTS, (m / SLOTS) & 1);
}

template <class IO>
__device__ __forceinline__ const unsigned char* box(const ItemLoop<IO>& L, int m) {
  return L.ring + (m % SLOTS) * BOX;
}

// S block J (keys 64J ..) of an instance with KT key tiles (kt_instance:
// KT = 2, 4, 9, 13, 16): m64nWk16 with W = 64, or the width the last block
// has left (32 at KT = 2, 16 at KT = 9 and 13), four k16 steps; s[32J ..]
// is its accumulator
template <int KT, int J>
__device__ __forceinline__ void s_block(float* s, uint64_t qd, uint64_t kd) {
  constexpr int NB = (KT + 3) / 4;
  if constexpr (J < NB) {
    constexpr int WIDTH = J < NB - 1 ? 64 : KT * 16 - 64 * (NB - 1);
    float(&acc)[WIDTH / 2] = *reinterpret_cast<float(*)[WIDTH / 2]>(s + 32 * J);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      Wgmma<WIDTH, 0>::mma(acc, desc_add(qd, ks * 32), desc_add(kd, ks * 32), ks > 0);
  }
}

// The warpgroup's items, in order (all 128 threads of it; its mbarriers
// initialised, the key row staged, and the turns begun), for N <= 16*KT.
// The products are the same at every N of an instance: blocks and k16
// steps past N read the last loaded box again, and their scores are masked
// (-inf) and their P zero, so no branch stands between the wgmma of a
// sequence; only the loads follow N.
template <int KT, class IO, class T>
__device__ __forceinline__ void attend_items(const ItemLoop<IO>& L, T& turns) {
  const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32, t = lane & 3;
  const int wg = threadIdx.x / 128;
  const int N = L.io.N, nblk = (N + 63) / 64;
  const int per = 1 + 2 * nblk, total = L.items * per;
  int issued = 0;
  auto refill = [&](int released) {  // boxes below `released` are free
    if (tw == 0)
      for (; issued < total && issued < released + SLOTS; ++issued) issue_box(L, issued, nblk);
  };
  refill(0);
  const int r0 = L.q0 + warp * 16 + lane / 4, r1 = r0 + 8;  // this thread's rows
  const bool warp_live = L.q0 + warp * 16 < N;

  for (int it = 0; it < L.items; ++it) {
    const int m0 = it * per, h = L.first + it * L.step;
    auto k_box = [&](int j) { return box(L, m0 + 1 + min(j, nblk - 1)); };
    auto v_box = [&](int j) { return box(L, m0 + 1 + nblk + min(j, nblk - 1)); };

    // ---- S = q.K^T, the whole row of keys
    for (int k = 0; k <= nblk; ++k) wait_box(L, m0 + k);
    float s[KT * 8];
    fence_operand(s);
    turns.acquire();
    wgmma_fence();
    const uint64_t qd = desc_sw128(box(L, m0));
    s_block<KT, 0>(s, qd, desc_sw128(k_box(0)));
    s_block<KT, 1>(s, qd, desc_sw128(k_box(1)));
    s_block<KT, 2>(s, qd, desc_sw128(k_box(2)));
    s_block<KT, 3>(s, qd, desc_sw128(k_box(3)));
    wgmma_commit();
    turns.release();
    wgmma_wait<0>();
    fence_operand(s);
    named_barrier(BAR_WG + wg, 128);  // every warp's share of q and K is read
    refill(m0 + 1 + nblk);

    // ---- the exact softmax of the thread's two rows, P packed as A: n8
    // tile i holds columns 8i + 2t, +1 in s[4i], s[4i+1] (row r0) and
    // s[4i+2], s[4i+3] (row r1)
    uint32_t p[KT][4];
    if (warp_live) {
      // exp(x - max) as 2^(x log2 e - max log2 e): the scale and log2(e)
      // in one multiply, the key row already in that domain; keys past N
      // are -inf there and come out 0, so every tile is taken alike
      const float c = L.scale * LOG2E;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2 * KT; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(L.key_row + i * 8 + 2 * t);
        s[4 * i] = fmaf(s[4 * i], c, a.x);
        s[4 * i + 1] = fmaf(s[4 * i + 1], c, a.y);
        s[4 * i + 2] = fmaf(s[4 * i + 2], c, a.x);
        s[4 * i + 3] = fmaf(s[4 * i + 3], c, a.y);
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * KT; ++i) {
        s[4 * i] = fast_exp2(s[4 * i] - mx0);
        s[4 * i + 1] = fast_exp2(s[4 * i + 1] - mx0);
        s[4 * i + 2] = fast_exp2(s[4 * i + 2] - mx1);
        s[4 * i + 3] = fast_exp2(s[4 * i + 3] - mx1);
        l0 += s[4 * i] + s[4 * i + 1];
        l1 += s[4 * i + 2] + s[4 * i + 3];
      }
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
      for (int i = 0; i < 2 * KT; ++i) {
        p[i / 2][2 * (i % 2)] = pack_bf16x2(s[4 * i] * inv0, s[4 * i + 1] * inv0);
        p[i / 2][2 * (i % 2) + 1] = pack_bf16x2(s[4 * i + 2] * inv1, s[4 * i + 3] * inv1);
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < KT; ++kc) p[kc][0] = p[kc][1] = p[kc][2] = p[kc][3] = 0u;
    }

#pragma unroll
    for (int kc = 0; kc < KT; ++kc) fence_operand(p[kc]);

    // ---- O = P.V, one k16 step a key tile
    for (int k = 1 + nblk; k < per; ++k) wait_box(L, m0 + k);
    float o[32];
    fence_operand(o);
    turns.acquire();
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KT; ++kc)
      WgmmaRS<64, 1>::mma(o, p[kc], desc_add(desc_sw128_mn(v_box(kc / 4)), (kc % 4) * 2048),
                          kc > 0);
    wgmma_commit();
    turns.release();
    wgmma_wait<0>();
    fence_operand(o);
    named_barrier(BAR_WG + wg, 128);  // every warp's share of V is read
    refill(m0 + per);

    // ---- the context of the rows below N, bf16
    __nv_bfloat16* o0 = L.io.ctx(h, r0) + 2 * t;
    __nv_bfloat16* o1 = o0 + 8L * L.io.stride();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (r0 < N)
        *reinterpret_cast<__nv_bfloat162*>(o0 + i * 8) = __floats2bfloat162_rn(o[4 * i], o[4 * i + 1]);
      if (r1 < N)
        *reinterpret_cast<__nv_bfloat162*>(o1 + i * 8) =
            __floats2bfloat162_rn(o[4 * i + 2], o[4 * i + 3]);
    }
  }
}

// a CTA's setup: each warpgroup's ring mbarriers (its thread 0), the key
// row (every thread); ends with a barrier of the CTA
__device__ __forceinline__ void setup(const Smem& sm, const float* mask, int b, int N) {
  const int wg = threadIdx.x / 128;
  if (threadIdx.x % 128 == 0) {
    for (int s = 0; s < SLOTS; ++s) mbar_init(sm.bars + wg * SLOTS + s, 1);
    fence_barrier_init();
  }
  key_row(sm.key_row, mask, b, N);
  __syncthreads();
}

}  // namespace wgattn
}  // namespace clibd
