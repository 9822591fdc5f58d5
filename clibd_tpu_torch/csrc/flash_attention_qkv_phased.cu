// Flash-attention forward over the fused qkv projection, phased across a
// group of heads, for Hopper (sm_90a).
//
// Replaces the TPU experiment kernel tools/exp_flash.py::_phased_kernel,
// which computes the forward of flash_attention_qkv.cu with the per-head
// chain reordered: for a batch element, every head's q.k^T first, then every
// softmax, then every P.V (the question it asks: do the matrix units stay
// busy when the softmaxes no longer sit between dependent products?).  Same
// arithmetic as the forward kernel: S = q.k^T / sqrt(hd) in fp32 plus the
// optional [B, N] key mask, the exact fp32 row softmax, P rounded to bf16
// after the normalisation, V read as bf16, P.V accumulated in fp32.
//
// The schedule.  On the TPU the three phases are statement order inside one
// grid step that holds the whole batch element.  Here a phase is a stretch
// of the CTA between barriers, and what can overlap across it is a copy
// with compute: one CTA per (batch, 64 query rows, group of G heads), with
// four warps (16 query rows each) for every head it attends at once --
// min(G, 4) heads, so 4 to 16 warps; warp w takes the rows 16*(w%4) of heads
// w/4, w/4 + min(G, 4), ...  The phases are the CTA's:
//  * phase 1: K of the G heads (cp.async) in shared memory; each warp
//    writes its rows' fp32 S for its heads into shared memory with
//    mma.sync (the products of G heads back to back, no softmax between);
//  * phase 2: after a barrier, V of the G heads streams by cp.async into the
//    buffers K held while each warp takes the exact fp32 softmax of its rows
//    over shared memory (a row per pass, lanes across the keys) and writes
//    P as bf16 in place over the row's first half;
//  * phase 3: after the copies land, P.V per head (P by ldmatrix, V by
//    ldmatrix.trans) and ctx into [B, N, D] at column h*64.
// G is a template parameter (the divisors of the towers' 12 and 8 heads);
// the wrapper asks clibd_flash_phased_smem_bytes what a (N, G) needs and
// refuses a G that does not fit before launching.
//
// Shared memory per head at N=197 (208 keys): S 64 x 212 fp32 (54,272 B)
// plus one K/V buffer 208 x 72 bf16 (29,952 B): 84,224 B, so G=2 (168,448 B)
// fits the 232,448 B a CTA may have and G=3 does not; at N=133 (144 keys)
// 58,624 B per head, G up to 3.  The row stride 212 (4 words past the keys)
// makes the ldmatrix reads of P conflict-free.  Registers: a handful of
// fragments (16 x 8 score tile, q, the 16 x 64 output accumulator); ptxas'
// count is in PERF.md.
//
// Left on the table: one CTA per SM once G >= 2 (the S tiles take the
// shared memory), so one CTA's barriers stall the whole SM; the softmax
// reduces each row across a whole warp (two 5-step shuffle chains a row);
// S makes a round trip through shared memory that the register-resident
// forward kernel avoids; K and V re-read from L2 by every query tile; wgmma
// and TMA.

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int QROWS = 64;
constexpr int KS = HD + 8;  // K / V row stride in bf16
constexpr int CHUNKS = HD / 8;

__host__ __device__ constexpr int s_stride(int npad) { return npad + 4; }

// shared memory of one head: its fp32 S tile and its K (then V) buffer
__host__ __device__ constexpr size_t head_bytes(int npad) {
  return (size_t)QROWS * s_stride(npad) * sizeof(float) + (size_t)npad * KS * sizeof(__nv_bfloat16);
}

// heads a CTA of G attends at once, four warps each
__host__ __device__ constexpr int heads_at_once(int G) { return G < 4 ? G : 4; }

// cp.async the K (part 1) or V (part 2) columns of heads h0 .. h0+G-1 into
// the G buffers; keys past N are left alone (zeroed once)
template <int G>
__device__ __forceinline__ void copy_heads(__nv_bfloat16* KV, const __nv_bfloat16* base, long rs,
                                           int N, int NPAD, int D, int h0, int part) {
  for (int idx = threadIdx.x; idx < G * N * CHUNKS; idx += blockDim.x) {
    const int c = (idx % CHUNKS) * 8;
    const int r = (idx / CHUNKS) % N;
    const int gi = idx / CHUNKS / N;
    cp_async16(KV + (gi * NPAD + r) * KS + c, base + r * rs + part * D + (h0 + gi) * HD + c);
  }
  cp_async_commit();
}

template <int G>
__global__ void __launch_bounds__(heads_at_once(G) * 128, 1)
phased_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                   __nv_bfloat16* __restrict__ out, int N, int H, float scale) {
  const int KT = (N + 15) / 16;
  const int NPAD = KT * 16;
  const int SS = s_stride(NPAD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);  // [G][64][SS]: S, then P (bf16) in place
  __nv_bfloat16* KV = reinterpret_cast<__nv_bfloat16*>(smem_raw + (size_t)G * QROWS * SS * 4);

  // consecutive CTAs are the query tiles of one (batch, head group), so they
  // find its K and V in L2
  const int qtiles = (N + QROWS - 1) / QROWS;
  const int groups = H / G;
  const int b = blockIdx.x / (groups * qtiles);
  const int h0 = (blockIdx.x / qtiles % groups) * G;
  const int q0 = (blockIdx.x % qtiles) * QROWS;
  const int D = H * HD;
  const long rs = 3L * D;
  const __nv_bfloat16* base = qkv + (long)b * N * rs;
  const float* mrow = mask ? mask + (long)b * N : nullptr;

  // keys N .. NPAD-1 are zero in every buffer: their scores are -inf and a
  // zero V row keeps 0 * garbage out of the P.V sums
  for (int idx = threadIdx.x; idx < G * (NPAD - N) * CHUNKS; idx += blockDim.x) {
    const int c = (idx % CHUNKS) * 8;
    const int r = N + (idx / CHUNKS) % (NPAD - N);
    const int gi = idx / CHUNKS / (NPAD - N);
    *reinterpret_cast<uint4*>(KV + (gi * NPAD + r) * KS + c) = make_uint4(0, 0, 0, 0);
  }
  copy_heads<G>(KV, base, rs, N, NPAD, D, h0, 1);
  cp_async_wait<0>();
  __syncthreads();

  constexpr int STEP = heads_at_once(G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % 4;    // the warp's 16-row tile
  const int first = warp / 4;  // its first head in the group
  const int r0 = q0 + mt * 16 + g, r1 = r0 + 8;
  const bool live = q0 + mt * 16 < N;  // a 16-row tile wholly past N does nothing

  // ---- phase 1: S of every head of the group
  for (int gi = first; gi < G && live; gi += STEP) {
    const __nv_bfloat16* qg = base + (h0 + gi) * HD;
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int c = ks * 16 + t * 2;
      qa[ks][0] = r0 < N ? ld_u32(qg + r0 * rs + c) : 0u;
      qa[ks][1] = r1 < N ? ld_u32(qg + r1 * rs + c) : 0u;
      qa[ks][2] = r0 < N ? ld_u32(qg + r0 * rs + c + 8) : 0u;
      qa[ks][3] = r1 < N ? ld_u32(qg + r1 * rs + c + 8) : 0u;
    }
    const __nv_bfloat16* Kg = KV + gi * NPAD * KS;
    float* srow = S + (gi * QROWS + mt * 16 + g) * SS + t * 2;
    for (int nt = 0; nt < 2 * KT; ++nt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = Kg + (nt * 8 + g) * KS + t * 2;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        mma_bf16_16816(acc, qa[ks], ld_u32(kr + ks * 16), ld_u32(kr + ks * 16 + 8));
      const int col = nt * 8 + t * 2;
      const float add0 = col < N ? (mrow ? mrow[col] : 0.f) : -INFINITY;
      const float add1 = col + 1 < N ? (mrow ? mrow[col + 1] : 0.f) : -INFINITY;
      *reinterpret_cast<float2*>(srow + nt * 8) = make_float2(acc[0] * scale + add0, acc[1] * scale + add1);
      *reinterpret_cast<float2*>(srow + 8 * SS + nt * 8) =
          make_float2(acc[2] * scale + add0, acc[3] * scale + add1);
    }
  }
  __syncthreads();  // every warp is done with K

  // ---- phase 2: V streams into K's buffers while the softmaxes run
  copy_heads<G>(KV, base, rs, N, NPAD, D, h0, 2);
  for (int gi = first; gi < G && live; gi += STEP) {
    for (int rr = 0; rr < 16; ++rr) {
      float* row = S + (gi * QROWS + mt * 16 + rr) * SS;
      float p[MAX_N / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAX_N / 32; ++i) {
        const int c = lane + 32 * i;
        p[i] = c < NPAD ? row[c] : -INFINITY;
        mx = fmaxf(mx, p[i]);
      }
      mx = warp_max(mx);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_N / 32; ++i) {
        p[i] = expf(p[i] - mx);
        l += p[i];
      }
      l = warp_sum(l);
      __syncwarp();  // the whole row is in registers before any lane overwrites it
      __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(row);
#pragma unroll
      for (int i = 0; i < MAX_N / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < NPAD) prow[c] = __float2bfloat16_rn(p[i] / l);
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V has landed, for every thread

  // ---- phase 3: P.V of every head of the group
  for (int gi = first; gi < G && live; gi += STEP) {
    const __nv_bfloat16* P = reinterpret_cast<const __nv_bfloat16*>(S + (gi * QROWS + mt * 16) * SS);
    const __nv_bfloat16* Vg = KV + gi * NPAD * KS;
    float o[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t a[4];
      ldmatrix_x4(a, P + (lane & 15) * 2 * SS + kt * 16 + (lane >> 4) * 8);
      mma_kmajor<HD / 8>(o, a, Vg, KS, kt * 16, 0, lane);
    }
    __nv_bfloat16* o0 = out + ((long)b * N + r0) * D + (h0 + gi) * HD + t * 2;
    __nv_bfloat16* o1 = o0 + 8L * D;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      if (r0 < N) *reinterpret_cast<__nv_bfloat162*>(o0 + dt * 8) = __floats2bfloat162_rn(o[dt][0], o[dt][1]);
      if (r1 < N) *reinterpret_cast<__nv_bfloat162*>(o1 + dt * 8) = __floats2bfloat162_rn(o[dt][2], o[dt][3]);
    }
  }
}

template <int G>
cudaError_t launch(const void* qkv, const float* mask, void* out, int B, int N, int H, size_t smem,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(phased_bf16_kernel<G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long grid = (long)B * (H / G) * ((N + QROWS - 1) / QROWS);
  phased_bf16_kernel<G><<<grid, heads_at_once(G) * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), mask, static_cast<__nv_bfloat16*>(out), N, H,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch at (N, H, G) needs, 0 where the kernel does not take
// the shapes: N above MAX_N, or G not one of 1, 2, 3, 4, 6, 8, 12 dividing H.
long clibd_flash_phased_smem_bytes(int N, int H, int G) {
  const bool instantiated = G == 1 || G == 2 || G == 3 || G == 4 || G == 6 || G == 8 || G == 12;
  if (N < 1 || N > MAX_N || H < 1 || !instantiated || H % G) return 0;
  return (long)(G * head_bytes((N + 15) / 16 * 16));
}

// qkv [B, N, 3*H*64] bf16 contiguous; mask [B, N] fp32 or null; out
// [B, N, H*64] bf16; G heads per CTA.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for shapes it does
// not take.
int clibd_flash_attention_qkv_phased(const void* qkv, const float* mask, void* out, int B, int N,
                                     int H, int G, void* stream) {
  const size_t smem = (size_t)clibd_flash_phased_smem_bytes(N, H, G);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (B < 1 || smem == 0 || smem > (size_t)max_smem || (long)B * N > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return (int)launch<1>(qkv, mask, out, B, N, H, smem, s);
    case 2: return (int)launch<2>(qkv, mask, out, B, N, H, smem, s);
    case 3: return (int)launch<3>(qkv, mask, out, B, N, H, smem, s);
    case 4: return (int)launch<4>(qkv, mask, out, B, N, H, smem, s);
    case 6: return (int)launch<6>(qkv, mask, out, B, N, H, smem, s);
    case 8: return (int)launch<8>(qkv, mask, out, B, N, H, smem, s);
    default: return (int)launch<12>(qkv, mask, out, B, N, H, smem, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
