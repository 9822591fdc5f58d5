// Flash-attention backward over the fused qkv projection with P and dS
// kept on chip between its phases, for Hopper (sm_90a): the entry point of
// the whole-row backward core (wgmma_attention_bwd.cuh), which the main
// path's backward (flash_attention_qkv_bwd.cu) runs for N <= 208 too.
//
// Replaces the TPU experiment kernel tools/exp_flash.py::_phased_bwd_kernel,
// which computes the backward of flash_attention_qkv_bwd.cu with the chain
// phased across heads (every head's S and softmax, then every dV and dP,
// then every dS, then every dQ and dK), keeping every head's fp32 P and dP
// live between the phases (3.7 MB of VMEM per batch element at N=197).
// What phasing buys the TPU is that nothing of the chain is computed twice
// while the phases stay independent; the core keeps what the later phase
// needs -- Pb and dS, N x N in bf16 -- in shared memory instead, so S is
// computed once per (batch, head).  Its schedule, shared memory, bound and
// what it leaves on the table are in the core's header.

#include "wgmma_attention_bwd.cuh"

extern "C" {

// Shared memory a launch at N needs, 0 where the kernel does not take N
// (above 16 * MAX_KT = 208).
long clibd_flash_bwd_phased_smem_bytes(int N) { return clibd::wgbwd::whole_row_smem_bytes(N); }

// qkv [B, N, 3*H*64] and dout [B, N, H*64] bf16 contiguous, 16-byte
// aligned; mask [B, N] fp32 or null; dqkv [B, N, 3*H*64] bf16.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched);
// cudaErrorInvalidValue for shapes it does not take.
int clibd_flash_attention_qkv_bwd_phased(const void* qkv, const void* dout, const float* mask,
                                         void* dqkv, int B, int N, int H, void* stream) {
  return (int)clibd::wgbwd::launch_whole_row(qkv, dout, mask, dqkv, B, N, H,
                                             static_cast<cudaStream_t>(stream));
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
