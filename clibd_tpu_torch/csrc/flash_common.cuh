// Device helpers shared by the port's kernels for Hopper, sm_90a: the bf16
// tensor-core product, fragment packing and loads, asynchronous copies to
// shared memory, and warp/quad reductions.  Included by every csrc/*.cu;
// ops/cuda_build.py hashes it with each source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace clibd {

constexpr int HD = 64;      // head dim the kernels are written for
constexpr int MAX_N = 256;  // longest sequence: 16 key tiles of 16

// the key-tile count (16 keys a tile) of the kernel instance that takes N
// keys, for kernels instantiated at KT = 2, 4, 9, 13 and 16
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

// One warp's attention over one head for the 16 query rows row0 + g and
// row0 + g + 8 (g = lane/4, t = lane%4), the TPU kernel's arithmetic:
// S = q.k^T (bf16 in, fp32 accumulate) * scale + the key mask, keys N ..
// 16*KT-1 at -inf, the exact fp32 row softmax, P rounded to bf16 after the
// normalisation, o = P.V accumulated in fp32 (o[dt] holds output columns
// dt*8 + 2t, +1 of both rows).  q comes straight from device memory (`qg`:
// the head's q columns of row 0, row stride `rs`; rows past N read as 0); K
// (row stride HD+8) and V are staged in shared memory, zero past N: V^T
// (row stride 16*KT+8), or, with V_ROWS, V itself (row stride HD+8, read
// by ldmatrix.trans), the layout cp.async can copy.  The whole 16 x 16*KT
// score block stays in registers, and the score accumulators of key tile kt
// are the A fragment of P for the P.V product.
template <int KT, bool V_ROWS = false>
__device__ __forceinline__ void attend_rows_bf16(float (&o)[HD / 8][4], const __nv_bfloat16* qg,
                                                 long rs, const __nv_bfloat16* Ks,
                                                 const __nv_bfloat16* Vt, const float* mrow, int N,
                                                 int row0, float scale, int g, int t) {
  constexpr int KS = HD + 8;
  constexpr int VS = KT * 16 + 8;
  const int r0 = row0 + g, r1 = r0 + 8;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    qa[ks][0] = r0 < N ? ld_u32(qg + r0 * rs + c) : 0u;
    qa[ks][1] = r1 < N ? ld_u32(qg + r1 * rs + c) : 0u;
    qa[ks][2] = r0 < N ? ld_u32(qg + r0 * rs + c + 8) : 0u;
    qa[ks][3] = r1 < N ? ld_u32(qg + r1 * rs + c + 8) : 0u;
  }
  float s[2 * KT][4];
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* kr = Ks + (nt * 8 + g) * KS + t * 2;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      mma_bf16_16816(s[nt], qa[ks], ld_u32(kr + ks * 16), ld_u32(kr + ks * 16 + 8));
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = nt * 8 + t * 2 + j;
      const float add = col < N ? (mrow ? mrow[col] : 0.f) : -INFINITY;
      s[nt][j] = s[nt][j] * scale + add;
      s[nt][2 + j] = s[nt][2 + j] * scale + add;
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
  for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t pa[4];
    pa[0] = pack_bf16x2(s[2 * kt][0] / l0, s[2 * kt][1] / l0);
    pa[1] = pack_bf16x2(s[2 * kt][2] / l1, s[2 * kt][3] / l1);
    pa[2] = pack_bf16x2(s[2 * kt + 1][0] / l0, s[2 * kt + 1][1] / l0);
    pa[3] = pack_bf16x2(s[2 * kt + 1][2] / l1, s[2 * kt + 1][3] / l1);
    if constexpr (V_ROWS) {
      mma_kmajor<HD / 8>(o, pa, Vt, HD + 8, kt * 16, 0, g * 4 + t);
    } else {
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const __nv_bfloat16* vr = Vt + (dt * 8 + g) * VS + kt * 16 + t * 2;
        mma_bf16_16816(o[dt], pa, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }
}

// bytes of one head's K and V, each row-major at row stride HD+8 in bf16,
// for npad keys: one buffer of attend_heads_to_ctx's ring
__host__ __device__ constexpr size_t kv_rows_bytes(int npad) {
  return (size_t)2 * npad * (HD + 8) * sizeof(__nv_bfloat16);
}

// bytes of a [64, D] bf16 context tile at row stride D+8
__host__ __device__ constexpr size_t ctx_tile_bytes(int D) {
  return (size_t)64 * (D + 8) * sizeof(__nv_bfloat16);
}

// Every head's attention for the query rows q0 .. q0+rows-1 (rows <= 64) of
// one batch element, into the bf16 context tile `ctx` ([64][D+8] in shared
// memory) at column h*HD.  `base` is the element's fused qkv (row stride
// `rs`), `mrow` its key mask or null.  The heads go GROUP at a time over
// 4*GROUP warps: warp w attends over head h0 + w/4 for the 16-row tile w%4
// (attend_rows_bf16, V row-major).  Each group's K and V are copied by
// cp.async into a ring of STAGES buffers of GROUP heads at `kv`
// (STAGES*GROUP*kv_rows_bytes(16*KT) bytes); with two stages the next
// group's copies are in flight while this group computes.  Keys N .. 16*KT-1
// are zero in every buffer.  Returns after a barrier: the tile is complete
// and `kv` is free.
template <int KT, int GROUP, int STAGES>
__device__ __forceinline__ void attend_heads_to_ctx(__nv_bfloat16* ctx, unsigned char* kv,
                                                    const __nv_bfloat16* base, long rs,
                                                    const float* mrow, int N, int H, int q0,
                                                    int rows, float scale) {
  constexpr int NPAD = KT * 16;
  constexpr int KS = HD + 8;
  constexpr int THREADS = GROUP * 128;
  constexpr int CHUNKS = HD / 8;  // 16-byte pieces of a head's row
  const int D = H * HD;
  const int CS = D + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % 4, grp = warp / 4;
  // K of buffer `buf` (= stage * GROUP + head in group); V follows it
  auto k_of = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(kv + buf * kv_rows_bytes(NPAD));
  };

  const int pad = NPAD - N;
  for (int idx = threadIdx.x; idx < STAGES * GROUP * 2 * pad * CHUNKS; idx += THREADS) {
    const int c = (idx % CHUNKS) * 8;
    const int r = N + (idx / CHUNKS) % pad;
    const int half = idx / CHUNKS / pad;  // (buffer, K or V)
    *reinterpret_cast<uint4*>(k_of(half / 2) + (half % 2) * NPAD * KS + r * KS + c) =
        make_uint4(0, 0, 0, 0);
  }
  auto issue = [&](int i) {  // group i's K and V into stage i % STAGES
    for (int idx = threadIdx.x; idx < GROUP * 2 * N * CHUNKS; idx += THREADS) {
      const int c = (idx % CHUNKS) * 8;
      const int r = (idx / CHUNKS) % N;
      const int half = idx / CHUNKS / N;  // (head in group, K or V)
      const int h = i * GROUP + half / 2;
      if (h < H)
        cp_async16(k_of((i % STAGES) * GROUP + half / 2) + (half % 2) * NPAD * KS + r * KS + c,
                   base + r * rs + (1 + half % 2) * D + h * HD + c);
    }
    cp_async_commit();
  };

  const int groups = (H + GROUP - 1) / GROUP;
  issue(0);
  for (int i = 0; i < groups; ++i) {
    if (STAGES > 1 && i + 1 < groups) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // group i's K and V have landed, for every thread
    const int h = i * GROUP + grp;
    if (mt * 16 < rows && h < H) {
      const __nv_bfloat16* Ks = k_of((i % STAGES) * GROUP + grp);
      float o[HD / 8][4];
      attend_rows_bf16<KT, true>(o, base + h * HD, rs, Ks, Ks + NPAD * KS, mrow, N, q0 + mt * 16,
                                 scale, g, t);
      __nv_bfloat16* c0 = ctx + (mt * 16 + g) * CS + h * HD + t * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(c0 + dt * 8) = __floats2bfloat162_rn(o[dt][0], o[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(c0 + 8 * CS + dt * 8) =
            __floats2bfloat162_rn(o[dt][2], o[dt][3]);
      }
    }
    __syncthreads();  // this stage's buffers are no longer read
    if (STAGES == 1 && i + 1 < groups) issue(i + 1);
  }
}

// One warp's attention over one head for one query row, S exact in fp32:
// `qr` the row's q (HD floats in device memory), K [N][HD+1] and V [N][HD]
// (V rounded to bf16) in shared memory, `qs` [HD] and `ps` [N] the warp's
// scratch in shared memory; the fp32 softmax, P rounded to bf16, P.V in
// fp32.  Returns output columns lane and lane + 32.
__device__ __forceinline__ float2 attend_row_f32(const float* qr, const float* Ks, const float* Vs,
                                                 float* qs, float* ps, const float* mrow, int N,
                                                 float scale, int lane) {
  qs[lane] = qr[lane];
  qs[lane + 32] = qr[lane + 32];
  __syncwarp();
  float mx = -INFINITY;
  for (int j = lane; j < N; j += 32) {
    const float* kr = Ks + j * (HD + 1);
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) acc = fmaf(qs[d], kr[d], acc);
    const float sv = acc * scale + (mrow ? mrow[j] : 0.f);
    ps[j] = sv;
    mx = fmaxf(mx, sv);
  }
  mx = warp_max(mx);
  float l = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float e = expf(ps[j] - mx);
    ps[j] = e;
    l += e;
  }
  l = warp_sum(l);
  for (int j = lane; j < N; j += 32) ps[j] = bf16_round(ps[j] / l);
  __syncwarp();
  float o0 = 0.f, o1 = 0.f;
  for (int j = 0; j < N; ++j) {
    const float p = ps[j];
    o0 = fmaf(p, Vs[j * HD + lane], o0);
    o1 = fmaf(p, Vs[j * HD + lane + 32], o1);
  }
  __syncwarp();
  return make_float2(o0, o1);
}

}  // namespace clibd

extern "C" {
// the message of a CUDA error code the entry points return
const char* clibd_cuda_error_string(int code);
// the longest sequence the kernels take
int clibd_flash_attention_max_n(void);
}
