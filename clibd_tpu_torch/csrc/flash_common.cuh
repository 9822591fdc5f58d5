// Device helpers shared by the flash-attention kernels (forward and
// backward) for Hopper, sm_90a: the bf16 tensor-core product, fragment
// packing and loads, and warp/quad reductions.  Included by
// flash_attention_qkv.cu and flash_attention_qkv_bwd.cu; ops/cuda_build.py
// hashes it with each source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace clibd {

constexpr int HD = 64;      // head dim the kernels are written for
constexpr int MAX_N = 256;  // longest sequence: 16 key tiles of 16

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

// two floats -> one register of two bf16, lower column in the lower half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

}  // namespace clibd

extern "C" {
// the message of a CUDA error code the entry points return
const char* clibd_cuda_error_string(int code);
// the longest sequence the kernels take
int clibd_flash_attention_max_n(void);
}
