// y = alpha * x in fp32, for Hopper (sm_90a): the bandwidth probe.
//
// Replaces the TPU kernel tools/exp_attn.py::probe_pallas_bandwidth's `kern`
// (o = i * 2.0 on fp32 [8192, 2048], a grid of 64 blocks of [128, 2048]
// through VMEM).  It asks the same question on this card: what rate does a
// plain streaming pass reach against the published 3.35 TB/s?
//
// What bounds it on an H100: one multiply per 8 bytes moved, so device
// memory, nothing else: 2 * 4 * n bytes (134.2 MB at the probe's 64 MB
// input, 0.040 ms at 3.35 TB/s).  What it takes to get near that is enough
// bytes in flight on every SM to cover the memory latency.
//
// Design: a loop over 16-byte vectors (float4, neighbouring threads on
// neighbouring addresses), UNROLL = 8 loads a thread issued before their
// eight stores (128 bytes a thread in flight), plain loads and stores, and a
// grid of one CTA per THREADS * UNROLL vectors (32 KB), so every thread
// makes one pass; a scalar tail takes the last n % 4 elements.  The TPU
// kernel's [128, 2048] blocks are VMEM tiles with no counterpart here:
// nothing is staged on chip.  fp32 x * alpha rounds once, as the plain
// version does, so the two agree bit for bit.
//
// Measured on the card (PERF.md §6 row 6, tools/exp_probe_sched.py --copy,
// NVIDIA H100 80GB HBM3 at 700 W): the fastest of the designs tried, level
// with torch.mul at 64 MB.  Slower there: the loop it replaced (four
// vectors a thread, streaming __ldcs / __stcs hints, at most 8 CTAs an SM),
// and rings of Hopper's 1-D bulk copies (cp.async.bulk loads, and bulk or
// plain stores, through 4-32 KB shared-memory slots, one or two persistent
// CTAs an SM), which streamed as fast out of L2 but 6-18% slower out of
// device memory.  Left on the table: nothing measured against torch.mul and
// y.copy_, which reach the same 2.7 TB/s (81% of the published rate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // float4s a thread has in flight per step

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
      if (i < n4) v[u] = x[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long i = base + (long)u * THREADS;
      if (i < n4) y[i] = make_float4(v[u].x * alpha, v[u].y * alpha, v[u].z * alpha, v[u].w * alpha);
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
  const long n4 = n / 4;
  const long want = (n4 + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const int blocks = (int)(want < 1 ? 1 : want);
  scale_copy_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), n4, alpha, x + 4 * n4,
      y + 4 * n4, (int)(n - 4 * n4));
  return (int)cudaGetLastError();
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
