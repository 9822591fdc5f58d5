// LayerNorm over the last dimension, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's LayerNorm
// (clibd_tpu/models/layers.py::layernorm) into its neighbours.  In the port it
// was plain tensor code, about eleven kernels forward (casts, two means, a
// broadcast subtract, rsqrt, three broadcast products and sums) and their
// autograd backward, ~46 bytes of device traffic an element against a bound
// of 4.  Counted op by op over the flagship's transformer blocks in a train
// step (bf16, fast math, remat "attn"), it made about 60% of the bytes of
// every op that is no GEMM and no attention, and most of the step's kernel
// launches.  So every LayerNorm of the port on a CUDA tensor runs here.
//
// What bounds it on an H100: nothing but bytes.  A few operations an
// element against ~295 FLOP a byte at the ridge.  Forward: x read and y
// written once, 4 B an element in bf16 (8 in fp32), plus 8 B a row of
// statistics; 0.090 ms at 3.35 TB/s for the ViT's R = 500*197 rows of
// D = 768.  Backward: x and dy read, dx written, 6 B an element in bf16
// (12 in fp32), 0.135 ms at the same shape; the parameter gradients' partial
// sums are a few MB.
//
// Numerics, as the plain version (ops/layernorm.py::layernorm_reference):
//  * fast (bf16 x): the mean accumulated in fp32 and rounded to bf16; x -
//    mean rounded; the variance in fp32 over the rounded centred values;
//    1/sqrt(var + eps) rounded; then (.inv), (.scale) and (+bias) each
//    rounded, the fp32 parameters rounded to bf16 first.  The output equals
//    the plain version's but where the fp32 sums' order differs;
//  * exact: fp32 throughout (products and sums rounded one at a time, no
//    contraction into fma), the output rounded once to x's dtype;
//  * backward: the analytic gradient in fp32 from x and the row mean and
//    inverse std the forward used (8 bytes a row, nothing of [R, D]):
//    xhat = (x - mean) * inv, g = dy * scale (fast: the bf16-rounded
//    scale), dx = inv * (g - mean(g) - xhat * mean(g * xhat)) rounded once
//    to x's dtype; dscale = sum over rows of dy * xhat and dbias = sum of
//    dy, in fp32.  Each CTA writes its partial sums to a scratch of
//    [2][grid][D] and a second launch adds them up in a fixed order, so
//    the same inputs give the same bits.
//
// Design: one warp a row, the CTA's eight warps on eight rows, a grid of as
// many CTAs as the SMs hold at once walking the rows.
//  * Where D is a multiple of the 16-byte vector (8 bf16, 4 fp32) and the
//    row fits a warp's registers (bf16 D <= 1024: up to 4 vectors a lane;
//    fp32 D <= 768: up to 6), each lane reads its vectors of the row once,
//    keeps them in registers, and the row's sums come from warp shuffles:
//    one read and one write of every element (loading a warp's next row
//    before reducing the row in hand, two rows in flight, measured 14-16%
//    slower on the card).  The scale and bias are read per row as vectors
//    from L1.  The backward keeps each lane's partial sums of dscale and
//    dbias in registers across its rows, and the CTA adds its warps' in
//    shared memory in warp order.
//  * Any other D, stride or alignment: the same warp a row over single
//    elements, the row read again from L1/L2 for each pass, and the
//    parameter gradients' partials by a column kernel.
//  The path is chosen from D, the dtype, the row stride and the pointers'
//  alignment.  x may be strided by rows (the ViT's class row, x[:, 0]); y,
//  dy and dx are contiguous [R, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int WARPS = 8;  // a CTA's warps, one row each at a time
constexpr int THREADS = WARPS * 32;
constexpr int FWD_CTAS = 4;  // CTAs an SM: the forward's grid and register cap
constexpr int BWD_CTAS = 2;  // the backward's (its partial sums take registers)

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int V = 4;  // elements a 16-byte vector
  static constexpr int MAX_VECS = 6;
  using Vec = float4;
  __device__ static __forceinline__ void unpack(const Vec& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static __forceinline__ Vec pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ static __forceinline__ float round(float v) { return v; }
  __device__ static __forceinline__ float load(const float* p) { return *p; }
  __device__ static __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int V = 8;
  static constexpr int MAX_VECS = 4;
  using Vec = uint4;
  __device__ static __forceinline__ void unpack(const Vec& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ static __forceinline__ Vec pack(const float* f) {
    Vec r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return r;
  }
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// the sum over the warp, the same bits in every lane (each step adds the
// same two values in either order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the V fp32 values of a parameter at columns [c, c + V), 16-byte aligned
template <int V>
__device__ __forceinline__ void load_param(const float* __restrict__ p, int c, float* f) {
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + c) + k);
    f[4 * k] = t.x;
    f[4 * k + 1] = t.y;
    f[4 * k + 2] = t.z;
    f[4 * k + 3] = t.w;
  }
}

// y = LN(x) of one element from its centred value d (rounded already on the
// fast path), the row's inverse std and the parameters
template <typename T, bool FAST>
__device__ __forceinline__ float normalise(float d, float inv, float s, float b) {
  using IO = Io<T>;
  if (FAST) {
    const float t = IO::round(__fmul_rn(d, inv));
    return __fadd_rn(IO::round(__fmul_rn(t, IO::round(s))), IO::round(b));
  }
  return __fadd_rn(__fmul_rn(__fmul_rn(d, inv), s), b);
}

// the row's mean and inverse std as the plain version rounds them
template <typename T, bool FAST>
__device__ __forceinline__ float row_mean(float sum, int D) {
  const float mean = sum / (float)D;
  return FAST ? Io<T>::round(mean) : mean;
}

template <typename T, bool FAST>
__device__ __forceinline__ float row_inv(float sq, int D, float eps) {
  const float inv = 1.0f / sqrtf(sq / (float)D + eps);
  return FAST ? Io<T>::round(inv) : inv;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// CTAs an SM of the register path's forward: four (64 registers a thread)
// up to three vectors a lane, else three (85), where four would spill
template <int NV>
struct FwdCtas {
  static constexpr int value = NV <= 3 ? FWD_CTAS : FWD_CTAS - 1;
};

template <typename T, int NV, bool FAST>
__global__ void __launch_bounds__(THREADS, FwdCtas<NV>::value)
layernorm_forward_kernel(const T* __restrict__ x, long stride, const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y,
                         float* __restrict__ mean_out, float* __restrict__ rstd_out, int R, int D,
                         float eps) {
  using IO = Io<T>;
  constexpr int V = IO::V;
  const int lane = threadIdx.x & 31;
  const long warps = (long)gridDim.x * WARPS;
  for (long r = (long)blockIdx.x * WARPS + (threadIdx.x >> 5); r < R; r += warps) {
    const T* xr = x + r * stride;
    typename IO::Vec raw[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * 32 + lane) * V;
      if (c < D) raw[v] = *reinterpret_cast<const typename IO::Vec*>(xr + c);
    }
    float f[NV][V];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if ((v * 32 + lane) * V < D) {
        IO::unpack(raw[v], f[v]);
#pragma unroll
        for (int e = 0; e < V; ++e) sum += f[v][e];
      }
    }
    const float mean = row_mean<T, FAST>(warp_sum(sum), D);
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if ((v * 32 + lane) * V < D) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float d = f[v][e] - mean;
          if (FAST) d = IO::round(d);
          f[v][e] = d;
          sq += __fmul_rn(d, d);
        }
      }
    }
    const float inv = row_inv<T, FAST>(warp_sum(sq), D, eps);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * 32 + lane) * V;
      if (c < D) {
        float s[V], b[V], o[V];
        load_param<V>(scale, c, s);
        load_param<V>(bias, c, b);
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = normalise<T, FAST>(f[v][e], inv, s[e], b[e]);
        *reinterpret_cast<typename IO::Vec*>(y + r * D + c) = IO::pack(o);
      }
    }
    if (lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = inv;
    }
  }
}

// any D, stride and alignment: single elements, the row read once a pass
template <typename T, bool FAST>
__global__ void __launch_bounds__(THREADS, FWD_CTAS)
layernorm_forward_any_kernel(const T* __restrict__ x, long stride, const float* __restrict__ scale,
                             const float* __restrict__ bias, T* __restrict__ y,
                             float* __restrict__ mean_out, float* __restrict__ rstd_out, int R,
                             int D, float eps) {
  using IO = Io<T>;
  const int lane = threadIdx.x & 31;
  const long warps = (long)gridDim.x * WARPS;
  for (long r = (long)blockIdx.x * WARPS + (threadIdx.x >> 5); r < R; r += warps) {
    const T* xr = x + r * stride;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) sum += IO::load(xr + c);
    const float mean = row_mean<T, FAST>(warp_sum(sum), D);
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      float d = IO::load(xr + c) - mean;
      if (FAST) d = IO::round(d);
      sq += __fmul_rn(d, d);
    }
    const float inv = row_inv<T, FAST>(warp_sum(sq), D, eps);
    for (int c = lane; c < D; c += 32) {
      float d = IO::load(xr + c) - mean;
      if (FAST) d = IO::round(d);
      IO::store(y + r * D + c, normalise<T, FAST>(d, inv, scale[c], bias[c]));
    }
    if (lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = inv;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// dx of one element from xhat, g = dy * scale and the row's two means
__device__ __forceinline__ float dx_of(float xh, float g, float inv, float mg, float mgx) {
  return inv * (g - mg - xh * mgx);
}

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, BWD_CTAS)
layernorm_backward_kernel(const T* __restrict__ x, long stride, const T* __restrict__ dy,
                          const float* __restrict__ scale, const float* __restrict__ mean,
                          const float* __restrict__ rstd, T* __restrict__ dx,
                          float* __restrict__ partial, int R, int D, int fast) {
  using IO = Io<T>;
  constexpr int V = IO::V;
  constexpr int WIDTH = NV * 32 * V;
  __shared__ __align__(16) float red[WARPS][WIDTH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long warps = (long)gridDim.x * WARPS;
  float ps[NV][V], pb[NV][V];  // this lane's columns' sums of dy * xhat and dy
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < V; ++e) ps[v][e] = pb[v][e] = 0.f;

  for (long r = (long)blockIdx.x * WARPS + warp; r < R; r += warps) {
    const T* xr = x + r * stride;
    const T* gr = dy + r * D;
    typename IO::Vec xa[NV], ga[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * 32 + lane) * V;
      if (c < D) {
        xa[v] = *reinterpret_cast<const typename IO::Vec*>(xr + c);
        ga[v] = *reinterpret_cast<const typename IO::Vec*>(gr + c);
      }
    }
    const float mu = mean[r], inv = rstd[r];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * 32 + lane) * V;
      if (c < D) {
        float xf[V], gf[V], s[V];
        IO::unpack(xa[v], xf);
        IO::unpack(ga[v], gf);
        load_param<V>(scale, c, s);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (xf[e] - mu) * inv;
          const float g = gf[e] * (fast ? IO::round(s[e]) : s[e]);
          sg += g;
          sgx += g * xh;
          ps[v][e] += gf[e] * xh;
          pb[v][e] += gf[e];
        }
      }
    }
    const float mg = warp_sum(sg) / (float)D, mgx = warp_sum(sgx) / (float)D;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * 32 + lane) * V;
      if (c < D) {
        float xf[V], gf[V], s[V], o[V];
        IO::unpack(xa[v], xf);
        IO::unpack(ga[v], gf);
        load_param<V>(scale, c, s);
#pragma unroll
        for (int e = 0; e < V; ++e)
          o[e] = dx_of((xf[e] - mu) * inv, gf[e] * (fast ? IO::round(s[e]) : s[e]), inv, mg, mgx);
        *reinterpret_cast<typename IO::Vec*>(dx + r * D + c) = IO::pack(o);
      }
    }
  }

  // the CTA's partial sums: each warp's columns into shared memory, then
  // every column summed over the warps in order, dscale's, then dbias'
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (v * 32 + lane) * V;
      if (c < D)
#pragma unroll
        for (int e = 0; e < V; ++e) red[warp][c + e] = q ? pb[v][e] : ps[v][e];
    }
    __syncthreads();
    float* out = partial + ((long)q * gridDim.x + blockIdx.x) * D;
    for (int j = threadIdx.x; j < D; j += THREADS) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += red[w][j];
      out[j] = t;
    }
    __syncthreads();
  }
}

// any D, stride and alignment: dx alone, the row read again for each pass
template <typename T>
__global__ void __launch_bounds__(THREADS, BWD_CTAS)
layernorm_backward_any_kernel(const T* __restrict__ x, long stride, const T* __restrict__ dy,
                              const float* __restrict__ scale, const float* __restrict__ mean,
                              const float* __restrict__ rstd, T* __restrict__ dx, int R, int D,
                              int fast) {
  using IO = Io<T>;
  const int lane = threadIdx.x & 31;
  const long warps = (long)gridDim.x * WARPS;
  for (long r = (long)blockIdx.x * WARPS + (threadIdx.x >> 5); r < R; r += warps) {
    const T* xr = x + r * stride;
    const T* gr = dy + r * D;
    const float mu = mean[r], inv = rstd[r];
    float sg = 0.f, sgx = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float g = IO::load(gr + c) * (fast ? IO::round(scale[c]) : scale[c]);
      sg += g;
      sgx += g * ((IO::load(xr + c) - mu) * inv);
    }
    const float mg = warp_sum(sg) / (float)D, mgx = warp_sum(sgx) / (float)D;
    for (int c = lane; c < D; c += 32) {
      const float g = IO::load(gr + c) * (fast ? IO::round(scale[c]) : scale[c]);
      IO::store(dx + r * D + c, dx_of((IO::load(xr + c) - mu) * inv, g, inv, mg, mgx));
    }
  }
}

// the any-D path's partial sums of dscale and dbias: a thread a column, CTA
// row p of the grid over rows p, p + G, ...
template <typename T>
__global__ void __launch_bounds__(THREADS)
layernorm_param_partial_kernel(const T* __restrict__ x, long stride, const T* __restrict__ dy,
                               const float* __restrict__ mean, const float* __restrict__ rstd,
                               float* __restrict__ partial, int R, int D) {
  using IO = Io<T>;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= D) return;
  const long G = gridDim.y;
  float ps = 0.f, pb = 0.f;
  for (long r = blockIdx.y; r < R; r += G) {
    const float g = IO::load(dy + r * D + j);
    ps += g * ((IO::load(x + r * stride + j) - mean[r]) * rstd[r]);
    pb += g;
  }
  partial[blockIdx.y * (long)D + j] = ps;
  partial[(G + blockIdx.y) * D + j] = pb;
}

// dscale (blockIdx.y 0) and dbias (1): 32 columns a CTA; warp w adds the
// partials of its share of the G rows in order, then warp 0 adds the eight
// warps' sums in order
constexpr int SUM_WARPS = 8;

__global__ void __launch_bounds__(SUM_WARPS * 32)
layernorm_param_grad_kernel(const float* __restrict__ partial, int G, int D,
                            float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float red[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const float* part = partial + (long)blockIdx.y * G * D;
  const int chunk = (G + SUM_WARPS - 1) / SUM_WARPS;
  const int lo = w * chunk, hi = min(G, lo + chunk);
  float t = 0.f;
  if (j < D)
    for (int g = lo; g < hi; ++g) t += part[(long)g * D + j];
  red[w][lane] = t;
  __syncthreads();
  if (w == 0 && j < D) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < SUM_WARPS; ++k) s += red[k][lane];
    (blockIdx.y ? dbias : dscale)[j] = s;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// the grid: a CTA per WARPS rows, at most `per_sm` CTAs an SM
int grid_for(int R, int per_sm) {
  return (int)std::min<long>(((long)R + WARPS - 1) / WARPS, (long)per_sm * sm_count());
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// 16-byte vectors a lane for the register path, 0 for the any-D path
template <typename T>
int vectors_for(int D, long stride, bool aligned) {
  constexpr int V = Io<T>::V;
  if (!aligned || D % V || stride % V) return 0;
  const int nv = (D + 32 * V - 1) / (32 * V);
  return nv <= Io<T>::MAX_VECS ? nv : 0;
}

// f(std::integral_constant<int, NV>) for the NV that equals nv (1..MAX_VECS)
template <typename T, int NV = 1, typename F>
void with_vectors(int nv, F&& f) {
  if constexpr (NV <= Io<T>::MAX_VECS) {
    if (nv == NV) {
      f(std::integral_constant<int, NV>{});
      return;
    }
    with_vectors<T, NV + 1>(nv, f);
  }
}

template <typename T, bool FAST>
void forward(const T* x, long stride, const float* scale, const float* bias, T* y, float* mean,
             float* rstd, int R, int D, float eps, cudaStream_t s) {
  const int nv = vectors_for<T>(D, stride, aligned16(x) && aligned16(y) && aligned16(scale) &&
                                               aligned16(bias));
  if (!nv) {
    layernorm_forward_any_kernel<T, FAST><<<grid_for(R, FWD_CTAS), THREADS, 0, s>>>(
        x, stride, scale, bias, y, mean, rstd, R, D, eps);
    return;
  }
  with_vectors<T>(nv, [&](auto n) {
    constexpr int NV = decltype(n)::value;
    layernorm_forward_kernel<T, NV, FAST><<<grid_for(R, FwdCtas<NV>::value), THREADS, 0, s>>>(
        x, stride, scale, bias, y, mean, rstd, R, D, eps);
  });
}

template <typename T>
cudaError_t backward(const T* x, long stride, const T* dy, const float* scale, const float* mean,
                     const float* rstd, T* dx, float* dscale, float* dbias, float* partial, int R,
                     int D, int fast, cudaStream_t s) {
  const int grid = grid_for(R, BWD_CTAS);
  const int nv = vectors_for<T>(
      D, stride, aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(scale));
  if (nv) {
    with_vectors<T>(nv, [&](auto n) {
      layernorm_backward_kernel<T, decltype(n)::value>
          <<<grid, THREADS, 0, s>>>(x, stride, dy, scale, mean, rstd, dx, partial, R, D, fast);
    });
  } else {
    layernorm_backward_any_kernel<T><<<grid, THREADS, 0, s>>>(x, stride, dy, scale, mean, rstd,
                                                              dx, R, D, fast);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    layernorm_param_partial_kernel<T><<<dim3((D + THREADS - 1) / THREADS, grid), THREADS, 0, s>>>(
        x, stride, dy, mean, rstd, partial, R, D);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layernorm_param_grad_kernel<<<dim3((D + 31) / 32, 2), SUM_WARPS * 32, 0, s>>>(partial, grid, D,
                                                                                dscale, dbias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the backward's scratch for R rows of D: the partial sums of
// dscale and dbias, [2][grid][D] fp32.
long clibd_layernorm_bwd_scratch_bytes(int R, int D) {
  if (R < 1 || D < 1) return 0;
  return 2L * grid_for(R, BWD_CTAS) * D * (long)sizeof(float);
}

// x: R rows of D in `dtype` (0 fp32, 1 bf16), row r at x + r * stride
// (elements); scale, bias [D] fp32; y [R, D] contiguous of x's dtype; mean,
// rstd [R] fp32, the statistics the normalisation used.  fast (bf16 only):
// the plain version's bf16 rounding points.  Launches on `stream` and
// returns the launch's error (0 = launched).
int clibd_layernorm_fwd(const void* x, const float* scale, const float* bias, void* y, float* mean,
                        float* rstd, int R, int D, int stride, int dtype, int fast, float eps,
                        void* stream) {
  if (R < 1 || D < 1 || stride < D || dtype < 0 || dtype > 1 || (fast && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    forward<float, false>(static_cast<const float*>(x), stride, scale, bias,
                          static_cast<float*>(y), mean, rstd, R, D, eps, s);
  } else {
    auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    if (fast)
      forward<__nv_bfloat16, true>(xb, stride, scale, bias, yb, mean, rstd, R, D, eps, s);
    else
      forward<__nv_bfloat16, false>(xb, stride, scale, bias, yb, mean, rstd, R, D, eps, s);
  }
  return (int)cudaGetLastError();
}

// The backward from x (as the forward took it), dy [R, D] contiguous of x's
// dtype, the forward's scale and its mean and rstd: dx [R, D] contiguous of
// x's dtype, dscale and dbias [D] fp32; scratch of
// clibd_layernorm_bwd_scratch_bytes(R, D).  Two launches (three on the
// any-D path), in order on `stream`; returns the first error.
int clibd_layernorm_bwd(const void* x, const void* dy, const float* scale, const float* mean,
                        const float* rstd, void* dx, float* dscale, float* dbias, float* scratch,
                        int R, int D, int stride, int dtype, int fast, void* stream) {
  if (R < 1 || D < 1 || stride < D || dtype < 0 || dtype > 1 || (fast && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = backward<float>(static_cast<const float*>(x), stride, static_cast<const float*>(dy), scale,
                        mean, rstd, static_cast<float*>(dx), dscale, dbias, scratch, R, D, 0, s);
  else
    e = backward<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), stride,
                                static_cast<const __nv_bfloat16*>(dy), scale, mean, rstd,
                                static_cast<__nv_bfloat16*>(dx), dscale, dbias, scratch, R, D,
                                fast, s);
  return (int)e;
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
