// Flash-attention forward over the fused qkv projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel clibd_tpu/ops/pallas/attention.py::_flash_kernel.
// Same function: for each (batch, head), S = q.k^T / sqrt(hd) in fp32, plus
// an optional per-key additive mask ([B, N] fp32, HF convention: 0 or
// finfo(float32).min), an fp32 online softmax over blocks of 64 keys, P =
// exp(S - max) rounded to bf16, and P.V accumulated in fp32 and divided by
// the row sum at the end.  V is read as bf16 and the context stored in bf16.
// The kernel reads q, k and v of head h straight from the fused
// [B, N, 3*H*hd] tensor (column offsets h*hd, D + h*hd, 2D + h*hd) and
// writes ctx into [B, N, H*hd] at column h*hd: no head-split copy ever
// exists in device memory.  It takes any N >= 1.
//
// The one departure from the TPU kernel's arithmetic: P is rounded to bf16
// before the division by the row sum, not after (one sweep over the keys
// instead of two).  Each P differs from the reference's by at most one bf16
// rounding; chip_smoke.py holds max |kernel - plain| to 2e-2 and PERF.md
// records it.  A fully masked row (every score finfo(float32).min) comes out
// as the mean of V over its N keys, as in the plain version.
//
// What bounds it on an H100, at B=500 (bytes: q, k, v read and the context
// written once, 8*B*N*D, plus the mask; operations: 4*B*H*N^2*64):
//  * ViT N=197 H=12: 605 MB, 0.181 ms of bytes against 0.060 ms of
//    operations -- bytes;
//  * BarcodeBERT N=133 H=12: 0.122 ms of bytes, 0.027 ms of operations;
//  * BERT-small N=20 H=8, masked: 0.012 ms of bytes, nearly no operations;
//  * the overlap tokenizer's DNA tower, N=657 H=12, masked: 0.600 ms of
//    bytes against 0.670 ms of operations -- the tensor cores.
// Beside those: the exponentials (B*H*N^2: 233 M at N=197, ~0.06 ms at the
// SFUs' 16 a cycle an SM) and the fp32 work of the softmax around them; the
// 64-row grain of wgmma, which pads each head's query rows and keys to
// whole tiles (N=197: 256 x 256 products for 197 x 197); and, measured
// (PERF.md §6, clock64 sections of tools/exp_flash_sched.py --row1), the
// chain of each warpgroup: wait for K, S (four dependent k16 steps), the
// softmax, P.V, in which no unit is busy for long.  Loading everything from
// L2 saves at most 4%; dropping the softmax saves 21-29% at N >= 133.
//
// Design:
//  * a CTA takes items, each W consecutive 64-row query tiles of one (batch,
//    head), W consumer warpgroups a tile each, W = 4, 2 or 1 by N
//    (warpgroups_for: four at N=197, whose CTA reads a head's K and V once
//    for all its tiles; one at the other shapes); the CTAs are persistent,
//    four warpgroups an SM (128 registers a thread), walking the items with
//    a stride of the grid, so the next item's q and first K/V blocks load
//    while this one is computed;
//  * loads by TMA from one 3-D map over qkv [B, N, 3D] with the 128-byte
//    swizzle (wgmma_attention.cuh's FusedQkv), so rows past N arrive as
//    zeros, never the next batch's; q in two boxes a warpgroup (this item's
//    and the next one's), K and V in blocks of 64 keys through a ring of
//    2..SLOTS_MAX (K, V) slots, a full mbarrier each, numbered through the
//    CTA's items.  No warp only loads: the warp that releases a slot last (a
//    counter in shared memory, atomicInc, one arrival a warp) refills it,
//    and a warpgroup releases block j-1's slot while its S of block j runs;
//  * S = q.K^T on wgmma in SS form, four k16 steps; O += P.V in RS form
//    (WgmmaRS: P from the registers of S, V's box MN-major);
//  * the online softmax in registers, a row in the four threads of a quad,
//    exp2 with the scale times log2 e folded into one multiply; the additive
//    key row (the mask times log2 e, -inf past N) staged in shared memory
//    once a CTA, or once an item with a mask (two buffers, in chunks of
//    KR_BLOCKS blocks past 1024 keys); a whole block without a mask skips
//    it; a warp whose 16 rows all lie past N does no softmax;
//  * the last key block's softmax and P.V take its TAIL keys (16, 32 or 64:
//    the keys N has past its whole blocks, rounded up), so the 5 keys past
//    192 at N=197 cost one k16 step of P.V and two n8 tiles of softmax; no
//    branch stands inside a wgmma sequence (ptxas would put a
//    warpgroup.arrive before every product: C7519), the width is a
//    template argument of straight-line code around whole sequences;
//  * the context leaves through the item's q box (its last S has read it)
//    by one TMA store, which drops the rows past N.
// Tried on the card and not kept (PERF.md §6): one item a CTA (a few
// percent faster at N=657, slower at N=20); the intra-warpgroup overlap of
// FlashAttention-3 (block j's S issued with block j-1's P.V, j's softmax
// while P.V runs), which gained nothing below N=657 and lost there;
// warpgroups taking turns on the tensor cores (5a's Turns), slower.
// Left on the table: the last query tile at N=197 and N=133 holds 5 live
// rows of 64 and costs a whole tile's products (3 of its 4 warps skip the
// softmax); at N=20 a tile is 20 rows of 64; S's four dependent k16 steps
// wait on each other, and the slot's release and refill (atomicInc, two
// expect_tx, two TMA issues) fill that wait; the softmax runs on the SFUs'
// exp2 alone (a degree-4 polynomial on the FMA pipes for one to three of a
// block's eight n8 tiles took ptxas past its registers, C7511, and ran
// 6-11% slower at N=197).
//
// fp32 inputs (precision checks, not the bf16 main path) go through a SIMT
// kernel that keeps S exact in fp32 and rounds P after the normalisation, as
// the reference does (two sweeps over the keys: flash_common.cuh's
// attend_head_f32).

#include <algorithm>

#include "wgmma_attention.cuh"

namespace {

using namespace clibd;
using namespace clibd::wgattn;

constexpr int SLOTS_MAX = 4;   // (K, V) block pairs a ring holds at most
constexpr int KR_BLOCKS = 16;  // key blocks of one staged chunk of the key row (1024 keys)
constexpr float C = LOG2E * 0.125f;  // the scale 1/sqrt(64) times log2(e)
constexpr int SM_SMEM = 233472;      // shared memory of an SM (228 KB), 1 KB of it a CTA's own
constexpr int WG_SM = 4;             // consumer warpgroups an SM: 128 registers a thread

__host__ __device__ constexpr int key_chunk(int nblk) {
  return 64 * (nblk < KR_BLOCKS ? nblk : KR_BLOCKS);
}

// shared memory of a CTA of W warpgroups with a ring of SL slots at nblk key
// blocks: 1 KB of alignment slack, two q boxes a warpgroup (this item's and
// the next one's; an item's box stages its context after its last S), the K
// and V boxes of the ring, two key row chunks, the mbarriers (q, K, V) and
// the ring's release counters
__host__ __device__ constexpr size_t fwd_smem_bytes(int W, int SL, int nblk) {
  return 1024 + (size_t)(2 * W + 2 * SL) * BOX + 2 * key_chunk(nblk) * sizeof(float) +
         (2 * W + 2 * SLOTS_MAX) * sizeof(uint64_t) + SLOTS_MAX * sizeof(unsigned);
}

// the ring's slots of a CTA of W warpgroups at nblk key blocks: as many as
// let WG_SM / W CTAs share an SM, up to SLOTS_MAX and no more than the
// blocks, and never fewer than two where there are two blocks (a
// warpgroup waits for block j's K before it releases block j-1's slot)
inline int ring_slots(int W, int nblk) {
  const int least = nblk > 1 ? 2 : 1;
  int SL = nblk < SLOTS_MAX ? nblk : SLOTS_MAX;
  while (SL > least && WG_SM / W * (fwd_smem_bytes(W, SL, nblk) + 1024) > SM_SMEM) --SL;
  return SL;
}

// the warpgroups of a CTA at N keys, as measured at the main path's four
// shapes (tools/exp_flash_sched.py --row1, PERF.md §6): as many (4, 2 or 1)
// as divide the query tiles, so that no warpgroup idles on a tile past N
// (N=197: four, whose CTA reads a head's K and V once; N=133, 20, 657: one)
inline int warpgroups_for(int N) {
  const int tiles = (N + 63) / 64;
  return tiles % 4 == 0 ? 4 : tiles % 2 == 0 ? 2 : 1;
}

// keys [key0, key0 + count) of an item's additive key row into `row`, in the
// base-2 domain of the softmax: the mask times log2(e) (0 without one), no
// lower than -FLT_MAX (finfo(float32).min * log2 e would overflow to -inf,
// and a fully masked row must stay uniform over its keys), and -inf past N.
// Every thread of the CTA takes part; a barrier must follow.
__device__ __forceinline__ void stage_keys(float* row, const float* mrow, int key0, int count,
                                           int N) {
  for (int c = threadIdx.x; c < count; c += blockDim.x) {
    const int k = key0 + c;
    row[c] = k >= N ? -INFINITY : mrow ? fmaxf(mrow[k] * LOG2E, -FLT_MAX) : 0.f;
  }
}

// The CTA's shared state: its boxes, barriers and key rows, the ring's size,
// the items it walks and the one it is at.  The ring's pairs are numbered
// through the CTA's items: pair m is block m % nblk of its item m / nblk.
struct Cta {
  const CUtensorMap* map;
  unsigned char* qbox;  // [2][W]: the q boxes of items of even and odd k
  uint64_t* qfull;      // [2][W]
  unsigned char* kbox;  // SL boxes of K, then SL of V
  unsigned char* vbox;
  uint64_t* kfull;      // SLOTS_MAX each
  uint64_t* vfull;
  unsigned* released;   // SLOTS_MAX: warps that released each slot in its round so far
  const float* mask;
  int N, H, W, nblk, groups, SL, warps, count, pairs;
  // the item the CTA is at (its index k among the CTA's, its batch element
  // and head, its first pair, its key row of key_chunk(nblk) floats, its
  // mask row) and the next one's batch element and head
  int k, b, h, m0, nb, nh;
  float* key_row;
  const float* mrow;

  __device__ __forceinline__ int item(int k) const { return blockIdx.x + k * gridDim.x; }

  // the calling warpgroup's q box of item kk (its thread 0), once the
  // context of item kk-2 has left that box; a tile past N (an item's last,
  // where W does not divide the tiles) loads rows 0 .. 63 and stores nothing
  __device__ __forceinline__ void load_q(int kk) const {
    const int wg = threadIdx.x / 128, it = item(kk), row = (it % groups * W + wg) * QROWS;
    uint64_t* bar = qfull + (kk % 2) * W + wg;
    tma_store_wait_read();
    mbar_arrive_expect_tx(bar, BOX);
    FusedQkv{map, nullptr, it / (H * groups), N, H * HD}.load(
        qbox + ((kk % 2) * W + wg) * BOX, bar, 0, it / groups % H, row < N ? row : 0);
  }
  // the next item's q, once this one's first S is issued
  __device__ __forceinline__ void next_q() const {
    if (threadIdx.x % 128 == 0 && k + 1 < count) load_q(k + 1);
  }

  // K and V of pair m, of this item or the next, into slot m % SL (one
  // thread)
  __device__ __forceinline__ void refill(int m) const {
    const bool next = m >= m0 + nblk;
    const int s = m % SL, row = (m - m0 - (next ? nblk : 0)) * 64, hh = next ? nh : h;
    const FusedQkv io{map, nullptr, next ? nb : b, N, H * HD};
    mbar_arrive_expect_tx(kfull + s, BOX);
    io.load(kbox + s * BOX, kfull + s, 1, hh, row);
    mbar_arrive_expect_tx(vfull + s, BOX);
    io.load(vbox + s * BOX, vfull + s, 2, hh, row);
  }
  __device__ __forceinline__ void wait_k(int j) const {
    mbar_wait(kfull + (m0 + j) % SL, ((m0 + j) / SL) & 1);
  }
  __device__ __forceinline__ void wait_v(int j) const {
    mbar_wait(vfull + (m0 + j) % SL, ((m0 + j) / SL) & 1);
  }
  __device__ __forceinline__ const unsigned char* k_of(int j) const {
    return kbox + (m0 + j) % SL * BOX;
  }
  __device__ __forceinline__ const unsigned char* v_of(int j) const {
    return vbox + (m0 + j) % SL * BOX;
  }
  // lane 0 of each warp, once its warpgroup's products with block j have
  // completed: the warp that releases the slot last loads pair m + SL into
  // it, which may be a block of the next item.  A round's releases all come
  // before the next round's, whose boxes need this one's refill.
  __device__ __forceinline__ void release(int j) const {
    const int m = m0 + j;
    if (threadIdx.x % 32 == 0 && atomicInc(released + m % SL, warps - 1) == warps - 1 &&
        m + SL < pairs)
      refill(m + SL);
  }
  // at block j past the first chunk of the key row: the next chunk, staged
  // by the whole CTA once every warpgroup's softmax of block j-1 is done
  __device__ __forceinline__ void next_keys(int j) const {
    if (j % KR_BLOCKS == 0) {
      __syncthreads();
      stage_keys(key_row, mrow, j * 64, key_chunk(nblk), N);
      __syncthreads();
    }
  }
};

// One warpgroup's query tile (rows q0 .. q0+63) over the head's key blocks:
// the online softmax state of the thread's two rows r0 and r0 + 8, O, and
// P of the block whose P.V is next.  Accumulator layouts: hopper_common's
// Wgmma (n8 tile i of S holds keys 8i + 2t, +1 in s[4i], s[4i+1] for row r0
// and s[4i+2], s[4i+3] for row r0 + 8; O likewise with dims for keys).
struct Tile {
  const Cta& cta;
  uint64_t qd;     // q box descriptor
  bool live;       // the warp has a row below N
  int t;           // lane % 4
  float s[32], o[32];
  uint32_t p[4][4];
  float m0, m1, l0, l1;

  // S = q.K_j^T over the block's 64 keys, four k16 steps (issued, not
  // committed); a narrower product for the last block would share
  // accumulator registers with this one, and ptxas then serialises every
  // wgmma of the kernel (C7511)
  __device__ __forceinline__ void issue_s(int j) {
    const uint64_t kd = desc_sw128(cta.k_of(j));
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      Wgmma<64, 0>::mma(s, desc_add(qd, ks * 32), desc_add(kd, ks * 32), ks > 0);
  }

  // O += P.V_j over WIDTH keys, one k16 step a 16 keys (issued, not committed)
  template <int WIDTH>
  __device__ __forceinline__ void issue_pv(int j) {
    const uint64_t vd = desc_sw128_mn(cta.v_of(j));
#pragma unroll
    for (int kc = 0; kc < WIDTH / 16; ++kc)
      WgmmaRS<64, 1>::mma(o, p[kc], desc_add(vd, kc * 2048), 1);
  }

  // block j's first WIDTH scores into exp2(x - max) in place, x = S * C + the
  // key row; the running maxima raised, the row sums rescaled and added to;
  // returns the factors O is to be rescaled by.  A whole block without a
  // mask adds nothing to its scores, so its max is C times that of S and
  // each exponent one multiply-add, exp2(S C - max): an operation an element
  // fewer.
  template <int WIDTH>
  __device__ __forceinline__ void softmax(int j, float& al0, float& al1) {
    const bool plain = cta.mask == nullptr && (j + 1) * 64 <= cta.N;
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (plain) {
#pragma unroll
      for (int i = 0; i < WIDTH / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx0 *= C;
      mx1 *= C;
    } else {
      const float* kr = cta.key_row + (j % KR_BLOCKS) * 64 + 2 * t;
#pragma unroll
      for (int i = 0; i < WIDTH / 8; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(kr + i * 8);
        s[4 * i] = fmaf(s[4 * i], C, a.x);
        s[4 * i + 1] = fmaf(s[4 * i + 1], C, a.y);
        s[4 * i + 2] = fmaf(s[4 * i + 2], C, a.x);
        s[4 * i + 3] = fmaf(s[4 * i + 3], C, a.y);
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
    }
    // every block holds a key below N, whose x is finite: so is the max, and
    // the first block's factor exp2(-inf - max) is 0
    mx0 = fmaxf(m0, quad_max(mx0));
    mx1 = fmaxf(m1, quad_max(mx1));
    al0 = fast_exp2(m0 - mx0);
    al1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // x - max: S C - max on a plain block, x already in s otherwise
    const float c = plain ? C : 1.f;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int i = 0; i < WIDTH / 8; ++i) {
      s[4 * i] = fast_exp2(fmaf(s[4 * i], c, -mx0));
      s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], c, -mx0));
      s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], c, -mx1));
      s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], c, -mx1));
      r0 += s[4 * i] + s[4 * i + 1];
      r1 += s[4 * i + 2] + s[4 * i + 3];
    }
    l0 = l0 * al0 + r0;
    l1 = l1 * al1 + r1;
  }

  // O rescaled, and P of WIDTH keys rounded to bf16 and packed as the A
  // registers of P.V
  template <int WIDTH>
  __device__ __forceinline__ void rescale_pack(float al0, float al1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[4 * i] *= al0;
      o[4 * i + 1] *= al0;
      o[4 * i + 2] *= al1;
      o[4 * i + 3] *= al1;
    }
#pragma unroll
    for (int i = 0; i < WIDTH / 8; ++i) {
      p[i / 2][2 * (i % 2)] = pack_bf16x2(s[4 * i], s[4 * i + 1]);
      p[i / 2][2 * (i % 2) + 1] = pack_bf16x2(s[4 * i + 2], s[4 * i + 3]);
    }
  }

  // the registers of an asynchronous P.V: its accumulator and A operand (S's
  // accumulator is fenced as s); no access of them moves across the start
  // of the product or the wait for it
  __device__ __forceinline__ void fence_pv() {
    fence_operand(o);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_operand(p[kc]);
  }

  // block j (WIDTH keys wide), one product after the other: S, its
  // softmax, P.V.  While S runs, the slot of block j-1 is released (the
  // last block's at its end) or, at block 0, the next item's q loaded.
  template <int WIDTH>
  __device__ __forceinline__ void block(int j) {
    if (j > 0) cta.next_keys(j);
    cta.wait_k(j);
    fence_operand(s);
    wgmma_fence();
    issue_s(j);
    wgmma_commit();
    if (j > 0)
      cta.release(j - 1);
    else
      cta.next_q();
    wgmma_wait<0>();
    fence_operand(s);
    if (live) {
      float al0, al1;
      softmax<WIDTH>(j, al0, al1);
      rescale_pack<WIDTH>(al0, al1);
    }
    fence_pv();
    cta.wait_v(j);
    wgmma_fence();
    issue_pv<WIDTH>(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_pv();
    if (j == cta.nblk - 1) cta.release(j);
  }
};

template <int W, int TAIL>
__global__ void __launch_bounds__(W * 128, WG_SM / W)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                       const __grid_constant__ CUtensorMap out_map, const float* __restrict__ mask,
                       int N, int H, int SL, int items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nblk = (N + 63) / 64, chunk = key_chunk(nblk), groups = (nblk + W - 1) / W;
  // the CTA's items are blockIdx.x, + gridDim.x, ...: item it is the query
  // tiles it % groups * W .. + W-1 of head it / groups % H of batch element
  // it / (H * groups), so the CTAs at work at one time share heads' K and V
  // in L2
  const int count = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;

  unsigned char* qbox = base;  // [2][W]: items of even and odd k
  unsigned char* kbox = qbox + 2 * W * BOX;
  unsigned char* vbox = kbox + SL * BOX;
  float* key_rows = reinterpret_cast<float*>(vbox + SL * BOX);  // [2][chunk]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(key_rows + 2 * chunk);  // [2][W]
  uint64_t* kfull = qfull + 2 * W;
  uint64_t* vfull = kfull + SLOTS_MAX;
  unsigned* released = reinterpret_cast<unsigned*>(vfull + SLOTS_MAX);
  Cta cta{&qkv_map, qbox, qfull, kbox, vbox, kfull, vfull, released, mask,
          N, H, W, nblk, groups, SL, 4 * W, count, count * nblk};
  // the key row is the same for every item without a mask, unless it is
  // staged in chunks
  const bool restage = mask != nullptr || nblk > KR_BLOCKS;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2 * W; ++w) mbar_init(qfull + w, 1);
    for (int s = 0; s < SLOTS_MAX; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      released[s] = 0u;
    }
    fence_barrier_init();
  }

  for (int k = 0; k < count; ++k) {
    const int it = cta.item(k), nit = cta.item(k + 1);
    cta.k = k;
    cta.b = it / (H * groups);
    cta.h = it / groups % H;
    cta.nb = nit / (H * groups);
    cta.nh = nit / groups % H;
    cta.m0 = k * nblk;
    cta.key_row = key_rows + (restage ? k % 2 : 0) * chunk;
    cta.mrow = mask ? mask + (long)cta.b * N : nullptr;
    // the key row: every warp is done with item k-2's copy (this one's
    // buffer) once the CTA has passed the barrier after staging item k-1's.
    // Nothing else waits for the other warps: a warpgroup's q box is its own
    // thread 0's to refill, once that thread has passed the products that
    // read it and the store that reads it last
    if (k == 0 || restage) {
      stage_keys(cta.key_row, cta.mrow, 0, chunk, N);
      __syncthreads();
    }
    if (k == 0 && tw == 0) {
      cta.load_q(0);
      if (wg == 0)
        for (int m = 0; m < SL && m < cta.pairs; ++m) cta.refill(m);
    }

    const int q0 = (it % groups * W + wg) * QROWS;
    unsigned char* box = qbox + ((k % 2) * W + wg) * BOX;
    Tile tile{cta, desc_sw128(box), q0 + warp * 16 < N, lane & 3};
#pragma unroll
    for (int i = 0; i < 32; ++i) tile.o[i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      tile.p[kc][0] = tile.p[kc][1] = tile.p[kc][2] = tile.p[kc][3] = 0u;
    tile.m0 = tile.m1 = -INFINITY;
    tile.l0 = tile.l1 = 0.f;
    mbar_wait(qfull + (k % 2) * W + wg, (k / 2) & 1);

    // the whole blocks, then the TAIL-wide last block
    for (int j = 0; j < nblk - 1; ++j) tile.block<64>(j);
    tile.block<TAIL>(nblk - 1);

    // the context, bf16, through the q box (its last S has completed) and
    // one TMA store, which drops the rows past N
    if (q0 < N) {
      if (tile.live) {
        const float inv0 = 1.f / quad_sum(tile.l0), inv1 = 1.f / quad_sum(tile.l1);
        const int r = warp * 16 + lane / 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(box + sw128_offset(r, 8 * i + 2 * tile.t)) =
              __floats2bfloat162_rn(tile.o[4 * i] * inv0, tile.o[4 * i + 1] * inv0);
          *reinterpret_cast<__nv_bfloat162*>(box + sw128_offset(r + 8, 8 * i + 2 * tile.t)) =
              __floats2bfloat162_rn(tile.o[4 * i + 2] * inv1, tile.o[4 * i + 3] * inv1);
        }
      }
      fence_proxy_async();
      named_barrier(BAR_WG + wg, 128);
      if (tw == 0) {
        tma_store_3d(&out_map, box, cta.h * HD, q0, cta.b);
        tma_store_commit();
      }
    }
  }
  if (tw == 0) tma_store_wait_read();  // the boxes stay until the stores have read them
}

template <int W, int TAIL>
cudaError_t launch(const CUtensorMap& qkv_map, const CUtensorMap& out_map, const float* mask,
                   int B, int N, int H, cudaStream_t stream) {
  const int nblk = (N + 63) / 64, SL = ring_slots(W, nblk);
  const size_t smem = fwd_smem_bytes(W, SL, nblk);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<W, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long items = (long)B * H * ((nblk + W - 1) / W);
  if (items > 0x7fffffffL) return cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int grid = (int)std::min<long>(items, (long)(WG_SM / W) * sms);
  flash_fwd_wgmma_kernel<W, TAIL><<<grid, W * 128, smem, stream>>>(qkv_map, out_map, mask, N, H,
                                                                   SL, (int)items);
  return cudaGetLastError();
}

// the instance for N's last block: the keys past the whole blocks (1 .. 64),
// rounded up to 16, 32 or 64
template <int W>
cudaError_t launch_tail(const CUtensorMap& qkv_map, const CUtensorMap& out_map, const float* mask,
                        int B, int N, int H, cudaStream_t stream) {
  const int tail = N - 64 * ((N - 1) / 64);
  if (tail <= 16) return launch<W, 16>(qkv_map, out_map, mask, B, N, H, stream);
  if (tail <= 32) return launch<W, 32>(qkv_map, out_map, mask, B, N, H, stream);
  return launch<W, 64>(qkv_map, out_map, mask, B, N, H, stream);
}

int launch_bf16(const void* qkv, const float* mask, void* out, int B, int N, int H, int W,
                cudaStream_t stream) {
  if (B < 1 || H < 1 || N < 1 || (W != 1 && W != 2 && W != 4) || (long)B * N > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qkv_map, out_map;
  cudaError_t e = encode_bf16_sw128(&qkv_map, qkv, N, 3 * H * HD, 64, B);
  if (e == cudaSuccess) e = encode_bf16_sw128(&out_map, out, N, H * HD, 64, B);
  if (e != cudaSuccess) return (int)e;
  switch (W) {
    case 1: return (int)launch_tail<1>(qkv_map, out_map, mask, B, N, H, stream);
    case 2: return (int)launch_tail<2>(qkv_map, out_map, mask, B, N, H, stream);
    default: return (int)launch_tail<4>(qkv_map, out_map, mask, B, N, H, stream);
  }
}

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                     float* __restrict__ out, int N, int H, float scale) {
  extern __shared__ float smem[];
  const HeadTile c = head_tile(N, H);
  const int D = H * HD;
  const long rs = 3L * D;
  const int lane = threadIdx.x % 32;
  float* orow = out + ((long)c.b * N + c.r0) * D + c.h * HD + lane;
  attend_head_f32<WARPS>(smem, qkv + (long)c.b * N * rs, rs, D, c.h, N, c.r0,
                         mask ? mask + (long)c.b * N : nullptr, scale,
                         [&](int r, float o0, float o1) {
                           orow[(long)r * D] = o0;
                           orow[(long)r * D + 32] = o1;
                         });
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*64] contiguous and 16-byte aligned, bf16 (dtype 1) or fp32
// (dtype 0); mask [B, N] fp32 contiguous or null; out [B, N, H*64] of qkv's
// dtype.  Any N >= 1 whose grid fits.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int clibd_flash_attention_qkv_fwd(const void* qkv, const float* mask, void* out, int B, int N,
                                  int H, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16(qkv, mask, out, B, N, H, warpgroups_for(N), s);
  const long grid = (long)B * H * ((N + KTILE - 1) / KTILE);
  if (dtype != 0 || B < 1 || H < 1 || N < 1 || grid > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = f32_attn_bytes(WARPS);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_f32_kernel<<<grid, THREADS, smem, s>>>(static_cast<const float*>(qkv), mask,
                                                   static_cast<float*>(out), N, H,
                                                   1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

// The bf16 kernel with W warpgroups a CTA (1, 2 or 4) in place of the
// number clibd_flash_attention_qkv_fwd picks (tools/exp_flash_sched.py
// times each).
int clibd_flash_attention_qkv_fwd_w(const void* qkv, const float* mask, void* out, int B, int N,
                                    int H, int W, void* stream) {
  return launch_bf16(qkv, mask, out, B, N, H, W, static_cast<cudaStream_t>(stream));
}

// the warpgroups a CTA of the bf16 kernel has at N keys
int clibd_flash_fwd_warpgroups(int N) { return warpgroups_for(N); }

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
