// y = alpha * x in fp32, for Hopper (sm_90a): the bandwidth probe.
//
// Replaces the TPU kernel tools/exp_attn.py::probe_pallas_bandwidth's `kern`
// (o = i * 2.0 on fp32 [8192, 2048], a grid of 64 blocks of [128, 2048]
// through VMEM).  It asks the same question on this card: what rate does a
// plain streaming pass reach against the published 3.35 TB/s?
//
// What bounds it on an H100: one multiply per 8 bytes moved, so device
// memory, nothing else: 2 * 4 * n bytes (134.2 MB at the probe's 64 MB
// input, 0.040 ms at 3.35 TB/s).
//
// Design: a grid-stride loop over 16-byte vectors (float4, neighbouring
// threads on neighbouring addresses), four loads a thread issued before
// their four stores so that enough bytes are in flight to cover the memory
// latency, streaming cache hints (the data is touched once), a grid of at
// most 8 CTAs per SM, and a scalar tail for the last n % 4 elements.  The
// TPU kernel's [128, 2048] blocks are VMEM tiles with no counterpart here:
// nothing is staged on chip.  fp32 x * alpha rounds once, as the plain
// version does, so the two agree bit for bit.

#include "flash_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // float4s a thread has in flight per step

__global__ void __launch_bounds__(THREADS)
scale_copy_kernel(const float4* __restrict__ x, float4* __restrict__ y, long n4, float alpha,
                  const float* __restrict__ xt, float* __restrict__ yt, int tail) {
  const long stride = (long)gridDim.x * THREADS * UNROLL;
  for (long base = (long)blockIdx.x * THREADS * UNROLL + threadIdx.x; base < n4; base += stride) {
    // every load of the step issued before any store: UNROLL * 16 bytes in
    // flight a thread
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long i = base + (long)u * THREADS;
      if (i < n4) v[u] = __ldcs(x + i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long i = base + (long)u * THREADS;
      if (i < n4)
        __stcs(y + i, make_float4(v[u].x * alpha, v[u].y * alpha, v[u].z * alpha, v[u].w * alpha));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) yt[threadIdx.x] = xt[threadIdx.x] * alpha;
}

}  // namespace

extern "C" {

// x, y: n fp32 values each, 16-byte aligned, not overlapping.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int clibd_scale_copy(const float* x, float* y, int n, float alpha, void* stream) {
  if (n < 0 || ((uintptr_t)x | (uintptr_t)y) % 16) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long n4 = n / 4;
  const long want = (n4 + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const int blocks = (int)(want < 1 ? 1 : (want < 8L * sms ? want : 8L * sms));
  scale_copy_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4, alpha, x + 4 * n4,
      y + 4 * n4, (int)(n - 4 * n4));
  return (int)cudaGetLastError();
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
