// Flash-attention backward over the fused qkv projection with P and dS
// kept on chip between its phases, for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel tools/exp_flash.py::_phased_bwd_kernel,
// which computes the backward of flash_attention_qkv_bwd.cu with the chain
// phased across heads (every head's S and softmax, then every dV and dP,
// then every dS, then every dQ and dK), keeping every head's fp32 P and dP
// live between the phases (3.7 MB of VMEM per batch element at N=197).  Same
// arithmetic as the backward kernel:
//   S  = q.k^T (fp32 accumulation) * scale + mask,  P = fp32 softmax(S)
//   Pb = bf16(P);  dO, V, K and Q are read as bf16
//   dV = Pb^T.dO,  dP = dO.V^T                     (fp32 accumulation)
//   dS = bf16(P * (dP - rowsum(P * dP)) * scale)   (the fp32 P)
//   dQ = dS.K,     dK = dS^T.Q                     (fp32 accumulation)
// written into the fused layout (columns h*64, D + h*64, 2D + h*64).
//
// The schedule.  What phasing buys the TPU is that nothing of the chain is
// computed twice while the phases stay independent.  The backward kernel
// here recomputes instead: S and dP once in a row pass and again in a column
// pass, and dP twice inside the row pass, because a CTA cannot hold an
// N x N fp32 tile.  The Hopper counterpart keeps what the later phases need
// -- Pb and dS, N x N in bf16 -- in shared memory, so each of S and dP is
// computed once per (batch, head).  One CTA per (batch, head), 8 warps:
//  * staging: K and V of the head in shared memory (cp.async);
//  * row phase, 16 query rows per warp: S for all keys in registers, the
//    exact fp32 softmax, dP = dO.V^T once into registers, rowsum(P * dP),
//    then Pb and dS of the rows into shared memory, and dQ = dS.K (dS read
//    back by ldmatrix, K by ldmatrix.trans) straight to device memory;
//  * column phase, after a barrier: Q and dO are copied into the buffers K
//    and V held, and each warp takes 16 keys: dV = Pb^T.dO and dK = dS^T.Q,
//    the transposed A fragments by ldmatrix.trans from Pb and dS.
// Pb and dS of a row past N are zero, so padded rows add nothing to dV, dK.
//
// Shared memory at N=197 (208 keys): Pb and dS 2 x 208 x 208 bf16
// (173,056 B), the K/V (then Q/dO) buffers 2 x 208 x 64 bf16 (53,248 B) and
// the per-key mask (832 B): 227,136 B of the 232,448 a CTA may have.  That
// fits only without padded rows, so every tile is XOR-swizzled (the 16-byte
// chunk index XORed with bits of the row) to keep the 8 rows of an ldmatrix
// phase, and of a fragment store, on distinct banks.  N above 208 does not
// fit; the wrapper refuses it before launching.  Registers: the row phase
// holds the 16 x 208 fp32 P and dP (2 x 104 a thread) at once; ptxas' count
// and spills are in PERF.md.
//
// Left on the table: one CTA of 8 warps per SM; 13 row tiles over 8 warps
// at N=197 (5 warps take two); Q and dO wait for the row phase to finish
// before they are copied; wgmma and TMA.

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_KT = 13;  // 208 keys: the largest N whose Pb and dS fit
constexpr int CHUNKS = HD / 8;

// Element offset of (row, col) in a row-major bf16 tile of W columns, the
// 16-byte chunk index XORed with the row bits that tell apart the 8 rows
// sharing a 128-byte bank line: W*2 bytes is 0, 64 or 32/96 modulo 128, so
// 1, 2 or 4 consecutive rows fall on distinct banks without it.
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int line = (W * 2) % 128;
  constexpr int sh = line == 0 ? 0 : line == 64 ? 1 : 2;
  return row * W + (col ^ (((row >> sh) & (7 >> sh)) << 3));
}

// shared memory of a launch with KT key tiles
__host__ __device__ constexpr size_t smem_bytes(int kt) {
  return (size_t)2 * (kt * 16) * (kt * 16) * 2 + (size_t)2 * (kt * 16) * HD * 2 + (size_t)kt * 16 * 4;
}

// cp.async N rows of one head's 64 columns (`src`, row stride rs) into a
// swizzled [.][HD] tile; rows past N keep their zeros
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long rs,
                                          int N) {
  for (int idx = threadIdx.x; idx < N * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    cp_async16(dst + swz<HD>(r, c), src + r * rs + c);
  }
}

// A fragments (16 rows from row0, 64 columns) of a head's rows in device
// memory (row stride rs; rows at or past N read as 0)
__device__ __forceinline__ void load_a_global(uint32_t (&a)[HD / 16][4], const __nv_bfloat16* src,
                                              long rs, int row0, int N, int g, int t) {
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    a[ks][0] = r0 < N ? ld_u32(src + r0 * rs + c) : 0u;
    a[ks][1] = r1 < N ? ld_u32(src + r1 * rs + c) : 0u;
    a[ks][2] = r0 < N ? ld_u32(src + r0 * rs + c + 8) : 0u;
    a[ks][3] = r1 < N ? ld_u32(src + r1 * rs + c + 8) : 0u;
  }
}

// acc (16 x 8) += A (16 x 64) . T[row0 .. row0+7, :]^T for a swizzled
// [.][HD] bf16 tile T (its rows are the 8 output columns)
__device__ __forceinline__ void mma_rows(float (&acc)[4], const uint32_t (&a)[HD / 16][4],
                                         const __nv_bfloat16* tile, int row0, int g, int t) {
  const int r = row0 + g;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    mma_bf16_16816(acc, a[ks], ld_u32(tile + swz<HD>(r, ks * 16 + t * 2)),
                   ld_u32(tile + swz<HD>(r, ks * 16 + t * 2 + 8)));
}

// acc (16 x 64) += A (16 x 16) . T[k0 .. k0+15, :] for a swizzled [.][HD]
// bf16 tile T, read k-major by ldmatrix.trans
__device__ __forceinline__ void mma_kmajor_swz(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                               const __nv_bfloat16* tile, int k0, int lane) {
  const int r = k0 + (lane & 15);
#pragma unroll
  for (int j = 0; j < HD / 8; j += 2) {
    uint32_t bfr[4];
    ldmatrix_x4_trans(bfr, tile + swz<HD>(r, j * 8 + (lane >> 4) * 8));
    mma_bf16_16816(acc[j], a, bfr[0], bfr[1]);
    mma_bf16_16816(acc[j + 1], a, bfr[2], bfr[3]);
  }
}

template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
bwd_phased_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ mask, __nv_bfloat16* __restrict__ dqkv, int N,
                       int H, float scale) {
  constexpr int NPAD = KT * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NPAD][NPAD], swizzled
  __nv_bfloat16* dS = Pb + NPAD * NPAD;                             // [NPAD][NPAD], swizzled
  __nv_bfloat16* buf0 = dS + NPAD * NPAD;                           // K, then Q: [NPAD][HD]
  __nv_bfloat16* buf1 = buf0 + NPAD * HD;                           // V, then dO
  float* key_add = reinterpret_cast<float*>(buf1 + NPAD * HD);      // the mask, -inf past N

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * HD;
  const long rs = 3L * D;  // qkv and dqkv row stride
  const __nv_bfloat16* qg = qkv + (long)b * N * rs + h * HD;
  const __nv_bfloat16* og = dout + (long)b * N * D + h * HD;
  __nv_bfloat16* dg = dqkv + (long)b * N * rs + h * HD;

  // rows N .. NPAD-1 of both buffers are zero for K and V and stay so for Q and dO
  for (int idx = threadIdx.x; idx < 2 * (NPAD - N) * CHUNKS; idx += THREADS) {
    const int r = N + (idx / CHUNKS) % (NPAD - N), c = (idx % CHUNKS) * 8;
    *reinterpret_cast<uint4*>((idx < (NPAD - N) * CHUNKS ? buf0 : buf1) + swz<HD>(r, c)) =
        make_uint4(0, 0, 0, 0);
  }
  for (int j = threadIdx.x; j < NPAD; j += THREADS)
    key_add[j] = j < N ? (mask ? mask[(long)b * N + j] : 0.f) : -INFINITY;
  copy_tile(buf0, qg + D, rs, N);
  copy_tile(buf1, qg + 2 * D, rs, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (N + 15) / 16;

  // ---- row phase: Pb and dS of every row into shared memory, and dQ
  for (int mt = warp; mt < tiles; mt += WARPS) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    float s[2 * KT][4];
    {
      uint32_t qa[HD / 16][4];
      load_a_global(qa, qg, rs, mt * 16, N, g, t);
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        mma_rows(s[nt], qa, buf0, nt * 8, g, t);
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

    float dp[2 * KT][4];
    float d0 = 0.f, d1 = 0.f;
    {
      uint32_t oa[HD / 16][4];  // dO rows, A fragments
      load_a_global(oa, og, D, mt * 16, N, g, t);
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        mma_rows(dp[nt], oa, buf1, nt * 8, g, t);
        d0 += s[nt][0] * dp[nt][0] + s[nt][1] * dp[nt][1];
        d1 += s[nt][2] * dp[nt][2] + s[nt][3] * dp[nt][3];
      }
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    const bool live0 = r0 < N, live1 = r1 < N;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      const int col = nt * 8 + t * 2;
      const uint32_t ds0 = pack_bf16x2((s[nt][0] * (dp[nt][0] - d0)) * scale,
                                       (s[nt][1] * (dp[nt][1] - d0)) * scale);
      const uint32_t ds1 = pack_bf16x2((s[nt][2] * (dp[nt][2] - d1)) * scale,
                                       (s[nt][3] * (dp[nt][3] - d1)) * scale);
      *reinterpret_cast<uint32_t*>(Pb + swz<NPAD>(r0, col)) = live0 ? pack_bf16x2(s[nt][0], s[nt][1]) : 0u;
      *reinterpret_cast<uint32_t*>(Pb + swz<NPAD>(r1, col)) = live1 ? pack_bf16x2(s[nt][2], s[nt][3]) : 0u;
      *reinterpret_cast<uint32_t*>(dS + swz<NPAD>(r0, col)) = live0 ? ds0 : 0u;
      *reinterpret_cast<uint32_t*>(dS + swz<NPAD>(r1, col)) = live1 ? ds1 : 0u;
    }
    __syncwarp();  // the warp's dS rows are in shared memory

    float dq[HD / 8][4];
    zero(dq);
    for (int kt = 0; kt < tiles; ++kt) {
      uint32_t a[4];
      ldmatrix_x4(a, dS + swz<NPAD>(mt * 16 + (lane & 15), kt * 16 + (lane >> 4) * 8));
      mma_kmajor_swz(dq, a, buf0, kt * 16, lane);
    }
    store_rows(dg, rs, dq, mt * 16, N, g, t);
  }
  __syncthreads();  // K and V are no longer read; Pb and dS are complete

  // ---- column phase: dK and dV, 16 keys per warp
  copy_tile(buf0, qg, rs, N);
  copy_tile(buf1, og, D, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // lane's row and column in a 16 x 16 block read transposed by ldmatrix:
  // matrices (keys 0-7, queries 0-7), (keys 8-15, queries 0-7), (keys 0-7,
  // queries 8-15), (keys 8-15, queries 8-15) -- the A fragment of the transpose
  const int tr_row = (lane & 7) + 8 * ((lane >> 4) & 1);
  const int tr_col = 8 * ((lane >> 3) & 1);
  for (int ct = warp; ct < tiles; ct += WARPS) {
    float dk[HD / 8][4], dv[HD / 8][4];
    zero(dk);
    zero(dv);
    for (int qt = 0; qt < tiles; ++qt) {
      uint32_t pa[4], da[4];
      ldmatrix_x4_trans(pa, Pb + swz<NPAD>(qt * 16 + tr_row, ct * 16 + tr_col));
      ldmatrix_x4_trans(da, dS + swz<NPAD>(qt * 16 + tr_row, ct * 16 + tr_col));
      mma_kmajor_swz(dv, pa, buf1, qt * 16, lane);
      mma_kmajor_swz(dk, da, buf0, qt * 16, lane);
    }
    store_rows(dg + D, rs, dk, ct * 16, N, g, t);
    store_rows(dg + 2 * D, rs, dv, ct * 16, N, g, t);
  }
}

template <int KT>
cudaError_t launch(const void* qkv, const void* dout, const float* mask, void* dqkv, int B, int N,
                   int H, cudaStream_t stream) {
  const size_t smem = smem_bytes(KT);
  cudaError_t e = cudaFuncSetAttribute(bwd_phased_bf16_kernel<KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  bwd_phased_bf16_kernel<KT><<<B * H, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout), mask,
      static_cast<__nv_bfloat16*>(dqkv), N, H, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// the key-tile count of the instance that takes N keys, 0 past MAX_KT
int kt_for(int N) { return N > 16 * MAX_KT ? 0 : kt_instance(N); }

}  // namespace

extern "C" {

// Shared memory a launch at N needs, 0 where the kernel does not take N
// (above 16 * MAX_KT = 208).
long clibd_flash_bwd_phased_smem_bytes(int N) {
  return N < 1 || kt_for(N) == 0 ? 0 : (long)smem_bytes(kt_for(N));
}

// qkv [B, N, 3*H*64] and dout [B, N, H*64] bf16 contiguous; mask [B, N] fp32
// or null; dqkv [B, N, 3*H*64] bf16.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for shapes it does
// not take.
int clibd_flash_attention_qkv_bwd_phased(const void* qkv, const void* dout, const float* mask,
                                         void* dqkv, int B, int N, int H, void* stream) {
  const size_t smem = (size_t)clibd_flash_bwd_phased_smem_bytes(N);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (B < 1 || H < 1 || smem == 0 || smem > (size_t)max_smem || (long)B * H > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kt_for(N)) {
    case 2: return (int)launch<2>(qkv, dout, mask, dqkv, B, N, H, s);
    case 4: return (int)launch<4>(qkv, dout, mask, dqkv, B, N, H, s);
    case 9: return (int)launch<9>(qkv, dout, mask, dqkv, B, N, H, s);
    default: return (int)launch<MAX_KT>(qkv, dout, mask, dqkv, B, N, H, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
