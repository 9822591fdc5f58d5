// Device helpers shared by the port's kernels for Hopper, sm_90a: the bf16
// tensor-core product (mma.sync), fragment packing and loads, asynchronous
// copies to shared memory, warp/quad reductions, the key-tiled attention core
// of the out-projection kernel (online_tile, reading K and V from TMA's
// swizzled tiles) and the fp32 kernels' attend_head_f32.  Included by the
// attention kernels and scale_copy.cu; ops/cuda_build.py hashes it with each
// source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace clibd {

constexpr int HD = 64;      // head dim the kernels are written for
// longest sequence of the kernels that hold a whole row of keys on chip (the
// experiment kernels and attention_bhnd); the key-tiled kernels take any N
constexpr int MAX_N = 256;

// the key-tile count (16 keys a tile) of the whole-row kernel instance that
// takes N keys, for kernels instantiated at KT = 2, 4, 9, 13 and 16
inline int kt_instance(int N) {
  const int kt = (N + 15) / 16;
  return kt <= 2 ? 2 : kt <= 4 ? 4 : kt <= 9 ? 9 : kt <= 13 ? 13 : 16;
}

// D += A.B, m16n8k16, bf16 in, fp32 accumulate.  A fragment: rows g and g+8,
// columns 2t..2t+1 and 2t+8..2t+9 (g = lane/4, t = lane%4); B fragment:
// k rows 2t..2t+1 and 2t+8..2t+9 of column g; C/D: rows g, g+8, columns
// 2t, 2t+1.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i, and each lane receives, of matrix i, the
// two elements (rows 2t, 2t+1; column g) in r[i] -- the B fragment of a
// matrix stored k-major (one row per k).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8x8 b16 matrices from shared memory, not transposed: lanes 8i..8i+7
// give the row addresses of matrix i, and each lane receives, of matrix i,
// the two elements (row g; columns 2t, 2t+1) in r[i] -- with lane l pointing
// at row (l & 15), column 8 * (l >> 4) of a row-major 16x16 tile, r is the
// A fragment of mma_bf16_16816.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two floats -> one register of two bf16, lower column in the lower half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (rows row0 + g and row0 + g + 8, columns col0 + 2t, +1, +8, +9)
// of a row-major bf16 tile in shared memory with row stride `rs`
__device__ __forceinline__ void ld_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int rs,
                                          int row0, int col0, int g, int t) {
  const __nv_bfloat16* p0 = tile + (row0 + g) * rs + col0 + t * 2;
  const __nv_bfloat16* p1 = p0 + 8 * rs;
  a[0] = ld_u32(p0);
  a[1] = ld_u32(p1);
  a[2] = ld_u32(p0 + 8);
  a[3] = ld_u32(p1 + 8);
}

// acc[j] (16 x 8, j < NT) += A (16 x 16) . B[k0 .. k0+15, col0 + 8j ..] for a
// k-major (one row per k) bf16 tile B in shared memory with row stride `rs`,
// B read with ldmatrix.trans two n-tiles at a time
template <int NT>
__device__ __forceinline__ void mma_kmajor(float (&acc)[NT][4], const uint32_t (&a)[4],
                                           const __nv_bfloat16* tile, int rs, int k0, int col0,
                                           int lane) {
  const __nv_bfloat16* p = tile + (k0 + (lane & 15)) * rs + col0 + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t bfr[4];
    ldmatrix_x4_trans(bfr, p + j * 8);
    mma_bf16_16816(acc[j], a, bfr[0], bfr[1]);
    mma_bf16_16816(acc[j + 1], a, bfr[2], bfr[3]);
  }
}

// 16 bytes global -> shared without passing through registers (cp.async);
// completion by cp_async_commit + cp_async_wait_all, then a barrier
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

// 4 bytes global -> shared by cp.async, zero-filled when !valid (`gmem` must
// still be a mapped address): for rows of floats that are not 16-byte aligned
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// wait until at most `PENDING` committed groups are still in flight (a
// multi-stage ring: the oldest stage has landed, the newer ones need not)
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// bytes of a [64, D] bf16 context tile at row stride D+8
__host__ __device__ constexpr size_t ctx_tile_bytes(int D) {
  return (size_t)64 * (D + 8) * sizeof(__nv_bfloat16);
}

// ---------------------------------------------------------------------------
// Key-tiled attention.  Keys (and, in the backward, queries) stream through
// shared memory KTILE rows at a time, so no kernel built on these holds a
// whole row of keys and every N >= 1 is taken.
// ---------------------------------------------------------------------------

constexpr int KTILE = 64;     // rows of a streamed tile

// the key mask of keys key0 .. key0+63 into `add` by cp.async (no thread
// waits on device memory), 0 past N or without a mask; read it with key_add,
// which masks the keys past N
template <int THREADS>
__device__ __forceinline__ void issue_mask_tile(float* add, const float* mrow, int key0, int N) {
  for (int j = threadIdx.x; j < KTILE; j += THREADS) {
    const bool live = key0 + j < N;
    if (mrow)
      cp_async4_zfill(add + j, mrow + (live ? key0 + j : 0), live);
    else
      add[j] = 0.f;
  }
}

// the additive score term of key `col` of a tile with `nvalid` keys below N
__device__ __forceinline__ float key_add(const float* add, int col, int nvalid) {
  return col < nvalid ? add[col] : -INFINITY;
}

// acc[nt] (16 x 8, nt < NT) = A (16 rows x 64, fragments `a`) times rows
// 8nt .. 8nt+7 of the tile, transposed (scores against keys), on a tile as
// TMA writes it with the 128-byte swizzle: rows of 64 bf16, 128 bytes apart,
// unpadded, the 16-byte group col/8 of row r at group (col/8) ^ (r % 8)
// (sw128_offset).  B fragments by ldmatrix, two k-steps per instruction;
// the 8 rows of each ldmatrix matrix land in 8 distinct groups, so it is
// conflict-free without padding.
template <int NT>
__device__ __forceinline__ void mma_rows_t_sw128(float (&acc)[NT][4],
                                                 const uint32_t (&a)[HD / 16][4],
                                                 const unsigned char* tile, int lane) {
  const int r = lane & 7;
  uint32_t off[HD / 32];
#pragma unroll
  for (int kp = 0; kp < HD / 32; ++kp) off[kp] = r * 128 + ((((lane >> 3) + 4 * kp) ^ r) & 7) * 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < HD / 32; ++kp) {
      uint32_t b[4];
      ldmatrix_x4(b, reinterpret_cast<const __nv_bfloat16*>(tile + nt * 8 * 128 + off[kp]));
      mma_bf16_16816(acc[nt], a[2 * kp], b[0], b[1]);
      mma_bf16_16816(acc[nt], a[2 * kp + 1], b[2], b[3]);
    }
  }
}

// mma_kmajor (col0 = 0) on a 128-byte-swizzled tile, as mma_rows_t_sw128
template <int NT>
__device__ __forceinline__ void mma_kmajor_sw128(float (&acc)[NT][4], const uint32_t (&a)[4],
                                                 const unsigned char* tile, int k0, int lane) {
  const int r = lane & 7;
  const unsigned char* p = tile + (k0 + (lane & 15)) * 128;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t bfr[4];
    ldmatrix_x4_trans(bfr, reinterpret_cast<const __nv_bfloat16*>(
                               p + ((((lane >> 4) + j) ^ r) & 7) * 16));
    mma_bf16_16816(acc[j], a, bfr[0], bfr[1]);
    mma_bf16_16816(acc[j + 1], a, bfr[2], bfr[3]);
  }
}

// the A fragment of the 16 x 16 block of columns 16kc .. 16kc+15 of a 16 x 8NT
// accumulator, rounded to bf16 (the accumulator layout of two n-tiles is the
// A layout of one k-step)
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&acc)[NT][4], int kc) {
  a[0] = pack_bf16x2(acc[2 * kc][0], acc[2 * kc][1]);
  a[1] = pack_bf16x2(acc[2 * kc][2], acc[2 * kc][3]);
  a[2] = pack_bf16x2(acc[2 * kc + 1][0], acc[2 * kc + 1][1]);
  a[3] = pack_bf16x2(acc[2 * kc + 1][2], acc[2 * kc + 1][3]);
}

// The online softmax of one warp's 16 query rows (g and g+8): the output
// accumulator, the running row maxima (equal across a quad) and the lane's
// share of the running row sums.
struct OnlineRows {
  float o[HD / 8][4];
  float m0, m1, l0, l1;
};

__device__ __forceinline__ void online_init(OnlineRows& st) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) st.o[dt][0] = st.o[dt][1] = st.o[dt][2] = st.o[dt][3] = 0.f;
  st.m0 = st.m1 = -INFINITY;
  st.l0 = st.l1 = 0.f;
}

// the exp() base of a running max: 0 while every score so far is -inf (a
// mask of -inf), so that exp(-inf - base) stays 0 instead of NaN
__device__ __forceinline__ float exp_base(float m) { return m == -INFINITY ? 0.f : m; }

// (batch, head, first row) of this CTA's 64-row tile in a grid of
// B*H*ceil(N/64) CTAs, tiles fastest so that the CTAs of one head run
// together and share its K and V (or Q and dO) in L2
struct HeadTile {
  int b, h, r0;
};

__device__ __forceinline__ HeadTile head_tile(int N, int H) {
  const int tiles = (N + KTILE - 1) / KTILE;
  const int bh = blockIdx.x / tiles;
  return {bh / H, bh % H, (blockIdx.x % tiles) * KTILE};
}

// One 64-key tile into the state: S = q.k^T * scale + mask in fp32, the
// running max raised to the tile's, the state rescaled, P = exp(S - max)
// rounded to bf16, o += P.V.  `Ks`, `Vs`: the tile's K and V rows (zero past
// N) as TMA's 128-byte swizzle lays them out; `add`: its key mask row in
// device memory (null without a mask); `nvalid` its keys below N.  exp is
// the fast __expf (ex2.approx): its error, a few fp32 ulps, is far below the
// bf16 rounding of P, and the precise expf would cost the issue slots that
// bound this loop.
__device__ __forceinline__ void online_tile(OnlineRows& st, const uint32_t (&qa)[HD / 16][4],
                                            const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                            const float* add, int nvalid, float scale,
                                            int lane) {
  const int t = lane & 3;
  float s[KTILE / 8][4];
  mma_rows_t_sw128<KTILE / 8>(s, qa, reinterpret_cast<const unsigned char*>(Ks), lane);
  float mx0 = st.m0, mx1 = st.m1;
#pragma unroll
  for (int nt = 0; nt < KTILE / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = nt * 8 + t * 2 + j;
      const float a = col < nvalid ? (add ? __ldg(add + col) : 0.f) : -INFINITY;
      s[nt][j] = fmaf(s[nt][j], scale, a);
      s[nt][2 + j] = fmaf(s[nt][2 + j], scale, a);
      mx0 = fmaxf(mx0, s[nt][j]);
      mx1 = fmaxf(mx1, s[nt][2 + j]);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float b0 = exp_base(mx0), b1 = exp_base(mx1);
  const float al0 = __expf(st.m0 - b0), al1 = __expf(st.m1 - b1);
  st.m0 = mx0;
  st.m1 = mx1;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < KTILE / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[nt][j] = __expf(s[nt][j] - b0);
      s[nt][2 + j] = __expf(s[nt][2 + j] - b1);
      r0 += s[nt][j];
      r1 += s[nt][2 + j];
    }
  }
  st.l0 = st.l0 * al0 + r0;
  st.l1 = st.l1 * al1 + r1;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    st.o[dt][0] *= al0;
    st.o[dt][1] *= al0;
    st.o[dt][2] *= al1;
    st.o[dt][3] *= al1;
  }
#pragma unroll
  for (int kc = 0; kc < KTILE / 16; ++kc) {
    uint32_t pa[4];
    pack_a(pa, s, kc);
    mma_kmajor_sw128<HD / 8>(st.o, pa, reinterpret_cast<const unsigned char*>(Vs), kc * 16,
                             lane);
  }
}

// bytes of attend_head_f32's shared memory with WARPS warps: a K tile
// [64][HD+1], a V tile [64][HD], the key row, the CTA's q rows [64][HD] and a
// P row per warp, all fp32
__host__ __device__ constexpr size_t f32_attn_bytes(int warps) {
  return (size_t)(KTILE * (HD + 1) + KTILE * HD + KTILE + KTILE * HD + warps * KTILE) *
         sizeof(float);
}

// One head's attention for the query rows q0 .. q0+63 (those below N) of one
// batch element with S exact in fp32 (precision checks, not the bf16 main
// path): row q0 + r goes to warp r % WARPS; the keys stream through shared
// memory 64 at a time (K, and V rounded to bf16), twice: the first sweep
// takes each row's max and sum, the second P = bf16(exp(S - max) / sum), the
// reference's rounding, and o += P.V in fp32.  `base` is the element's fused
// qkv (row stride rs, D = H*HD), `mrow` its key mask or null, `smem`
// f32_attn_bytes(WARPS) bytes.  store(r, o_lane, o_lane+32) is called once
// per live row, lane d holding output columns d and d + 32.  Starts and ends
// with a barrier.
template <int WARPS, typename Store>
__device__ __forceinline__ void attend_head_f32(float* smem, const float* base, long rs, int D,
                                                int h, int N, int q0, const float* mrow,
                                                float scale, Store store) {
  constexpr int THREADS = WARPS * 32, R = KTILE / WARPS;
  float* Ks = smem;                   // [64][HD + 1]: conflict-free row-per-lane reads
  float* Vs = Ks + KTILE * (HD + 1);  // [64][HD]
  float* add = Vs + KTILE * HD;       // [64]
  float* Qs = add + KTILE;            // [64][HD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ps = Qs + KTILE * HD + warp * KTILE;
  __syncthreads();  // the caller's earlier use of smem is over
  for (int idx = threadIdx.x; idx < KTILE * HD; idx += THREADS) {
    const int r = idx / HD;
    Qs[idx] = q0 + r < N ? base[(q0 + r) * rs + h * HD + idx % HD] : 0.f;
  }
  float m[R], l[R], o0[R], o1[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = o0[i] = o1[i] = 0.f;
  }
  const int tiles = (N + KTILE - 1) / KTILE;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int kt = 0; kt < tiles; ++kt) {
      __syncthreads();  // the previous tile is no longer read
      for (int idx = threadIdx.x; idx < KTILE * HD; idx += THREADS) {
        const int r = idx / HD, c = idx % HD, key = kt * KTILE + r;
        const bool live = key < N;
        Ks[r * (HD + 1) + c] = live ? base[key * rs + D + h * HD + c] : 0.f;
        Vs[r * HD + c] = live ? bf16_round(base[key * rs + 2 * D + h * HD + c]) : 0.f;
      }
      issue_mask_tile<THREADS>(add, mrow, kt * KTILE, N);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = warp + i * WARPS;
        if (q0 + r >= N) continue;  // the same for the whole warp
        const float* q = Qs + r * HD;
        float s[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float* kr = Ks + (lane + 32 * jj) * (HD + 1);
          float acc = 0.f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) acc = fmaf(q[d], kr[d], acc);
          s[jj] = fmaf(acc, scale, key_add(add, lane + 32 * jj, N - kt * KTILE));
        }
        if (sweep == 0) {
          const float mx = fmaxf(m[i], warp_max(fmaxf(s[0], s[1])));
          const float b = exp_base(mx);
          l[i] = l[i] * expf(m[i] - b) + warp_sum(expf(s[0] - b) + expf(s[1] - b));
          m[i] = mx;
        } else {
          ps[lane] = bf16_round(expf(s[0] - m[i]) / l[i]);
          ps[lane + 32] = bf16_round(expf(s[1] - m[i]) / l[i]);
          __syncwarp();
#pragma unroll 8
          for (int j = 0; j < KTILE; ++j) {
            o0[i] = fmaf(ps[j], Vs[j * HD + lane], o0[i]);
            o1[i] = fmaf(ps[j], Vs[j * HD + lane + 32], o1[i]);
          }
          __syncwarp();
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (q0 + warp + i * WARPS < N) store(warp + i * WARPS, o0[i], o1[i]);
  __syncthreads();
}

}  // namespace clibd

extern "C" {
// the message of a CUDA error code the entry points return
const char* clibd_cuda_error_string(int code);
}
