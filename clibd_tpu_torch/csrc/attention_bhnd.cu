// Attention from separate q, k, v [B, H, N, 64] bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/exp_attn.py::make_pallas_attn's `kern`
// (grid B/bb, a [bb, H, Np, hd] block of each of q, k, v in VMEM, the heads
// looped inside with 2D dots).  Same arithmetic: for each (batch, head),
// S = q.k^T in fp32 (bf16 in, fp32 accumulate) times hd^-1/2, the fp32 row
// softmax, P rounded to bf16 after the normalisation, P.V accumulated in
// fp32, the output cast to q's dtype.  The TPU script pads N to a multiple
// of 128 in device memory and sets the pad keys' scores to -1e30; their
// weights underflow to exactly 0, so they add nothing to the result and the
// kernel never pads in device memory: it masks the keys past N itself.
//
// What bounds it on an H100: 4*B*H*N^2*hd operations against q, k, v read
// and o written once (8*B*H*N*hd bytes in bf16), N/2 operations per byte:
// at B=256, H=12, N=197 that is 30.5 GFLOP (0.031 ms at 989 TFLOP/s)
// against 309.9 MB (0.093 ms at 3.35 TB/s), so device memory bounds it, as
// it does the fused-qkv kernel (csrc/flash_attention_qkv.cu).
//
// Design: the fused-qkv forward kernel's, with the head-split layout's
// strides.  One CTA per (batch, head), 4 warps; K and V^T of the head
// staged in shared memory as bf16 (zero past N); each warp takes 16 query
// rows at a time through clibd::attend_rows_bf16 (flash_common.cuh), which
// keeps the whole 16 x Npad score block in registers, and writes its rows of
// o.  q, k, v and o are contiguous [N, 64] slabs per (batch, head), so every
// row stride is hd = 64 and every load is a 16-byte vector.  Left on the
// table: as for the fused-qkv kernel (wgmma and TMA, a prefetch of the next
// head, several heads per CTA).

#include "flash_common.cuh"

namespace {

using namespace clibd;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <int KT>
__global__ void __launch_bounds__(THREADS)
attention_bhnd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int N,
                      float scale) {
  constexpr int NPAD = KT * 16;
  constexpr int KS = HD + 8;    // K row stride in bf16: conflict-free fragment loads
  constexpr int VS = NPAD + 8;  // V^T row stride in bf16: likewise
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vt = Ks + NPAD * KS;

  const long slab = (long)blockIdx.x * N * HD;  // this (batch, head)'s [N, HD]
  const __nv_bfloat16* qg = q + slab;
  const __nv_bfloat16* kg = k + slab;
  const __nv_bfloat16* vg = v + slab;

  // stage K and V^T; keys N..NPAD-1 are zero (their scores are masked to
  // -inf, and a zero V row keeps 0 * garbage out of the P.V sums)
  for (int idx = threadIdx.x; idx < NPAD * (HD / 8); idx += THREADS) {
    const int r = idx / (HD / 8);
    const int c = (idx % (HD / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < N) {
      kv = *reinterpret_cast<const uint4*>(kg + r * HD + c);
      vv = *reinterpret_cast<const uint4*>(vg + r * HD + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * KS + c) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int i = 0; i < 8; ++i) Vt[(c + i) * VS + r] = ve[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m_tiles = (N + 15) / 16;

  for (int mt = warp; mt < m_tiles; mt += WARPS) {
    float o[HD / 8][4];
    attend_rows_bf16<KT>(o, qg, HD, Ks, Vt, nullptr, N, mt * 16, scale, g, t);
    const int r0 = mt * 16 + g;
    const int r1 = r0 + 8;
    __nv_bfloat16* orow0 = out + slab + (long)r0 * HD + t * 2;
    __nv_bfloat16* orow1 = orow0 + 8 * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      if (r0 < N)
        *reinterpret_cast<__nv_bfloat162*>(orow0 + dt * 8) = __floats2bfloat162_rn(o[dt][0], o[dt][1]);
      if (r1 < N)
        *reinterpret_cast<__nv_bfloat162*>(orow1 + dt * 8) = __floats2bfloat162_rn(o[dt][2], o[dt][3]);
    }
  }
}

template <int KT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int N,
                   float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(KT * 16 * (HD + 8) + HD * (KT * 16 + 8)) * sizeof(__nv_bfloat16);
  cudaError_t e = cudaFuncSetAttribute(attention_bhnd_kernel<KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attention_bhnd_kernel<KT><<<BH, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), N, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: [B, H, N, 64] bf16 contiguous, 16-byte aligned; BH = B * H.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
int clibd_attention_bhnd(const void* q, const void* k, const void* v, void* out, int BH, int N,
                         void* stream) {
  if (BH < 1 || N < 1 || N > MAX_N || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                       (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kt_instance(N)) {
    case 2: return (int)launch<2>(q, k, v, out, BH, N, scale, s);
    case 4: return (int)launch<4>(q, k, v, out, BH, N, scale, s);
    case 9: return (int)launch<9>(q, k, v, out, BH, N, scale, s);
    case 13: return (int)launch<13>(q, k, v, out, BH, N, scale, s);
    default: return (int)launch<16>(q, k, v, out, BH, N, scale, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int clibd_flash_attention_max_n(void) { return MAX_N; }

}  // extern "C"
