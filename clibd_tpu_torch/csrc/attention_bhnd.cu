// Attention from separate q, k, v [B, H, N, 64] bf16, for Hopper (sm_90a),
// on the wgmma attention core of the experiment kernels
// (wgmma_attention.cuh).
//
// Replaces the TPU kernel tools/exp_attn.py::make_pallas_attn's `kern`
// (grid B/bb, a [bb, H, Np, hd] block of each of q, k, v in VMEM, the heads
// looped inside with 2D dots).  Same arithmetic: for each (batch, head),
// S = q.k^T in fp32 (bf16 in, fp32 accumulate) times hd^-1/2, the fp32 row
// softmax, P rounded to bf16 after the normalisation, P.V accumulated in
// fp32, the output cast to q's dtype.  The TPU script pads N to a multiple
// of 128 in device memory and sets the pad keys' scores to -1e30; their
// weights underflow to exactly 0.  Here nothing is padded in device memory:
// TMA reads a head's rows past N as zeros and the core gives the keys past
// N a score of -inf, so their weight is exactly 0 too.  N <= 256 (MAX_N).
//
// What bounds it on an H100: 4*B*H*N^2*hd operations against q, k, v read
// and o written once (8*B*H*N*hd bytes in bf16), N/2 operations per byte:
// at B=256, H=12, N=197 that is 30.5 GFLOP (0.031 ms at 989 TFLOP/s)
// against 309.9 MB (0.0925 ms at 3.35 TB/s), so device memory bounds it.
// On the card neither bound is reached: as for the phased and batched
// kernels on the same core, the chain of each item (loads, S, softmax, P.V)
// at three warpgroups a SM holds it (PERF.md §6).
//
// Design: the batched kernel's (flash_attention_qkv_batched.cu) with the
// head-split layout (HeadSplit).  q, k and v are viewed as [B*H, N, 64],
// one 3-D TMA map each, boxes [1, 64, 64] with the 128-byte swizzle, so a
// box never reaches into the next head's rows.  One CTA per (group of
// consecutive (batch, head) slabs, 64 query rows; slabs_for picks the group
// per launch) runs three consumer warpgroups; warpgroup w walks slabs w,
// w+3, ... of its group, each slab
// one item of the core: q and the slab's K and V by TMA into the
// warpgroup's own ring, S on wgmma, the softmax in registers in base 2, P.V
// on wgmma with P from registers, the rows below N stored from registers.
// The next item's q and K load under this item's softmax.  With no mask the
// key row (0 below N, -inf past it) is the same for every slab, so a group
// need not be one batch element; at H = 12 it is.  One CTA a SM by shared
// memory (three 72 KB rings).
//
// Left on the table: see wgmma_attention.cuh (one item in flight a
// warpgroup; the 5 live rows of the last query tile at N=197 cost a whole
// tile); and the query tiles of a slab each load its K and V.

#include "wgmma_attention.cuh"

namespace {

using namespace clibd;
using namespace clibd::wgattn;

constexpr int W = 3;  // consumer warpgroups

// (batch, head) slabs a CTA walks: of 3, 6, 12 and 24, the largest whose
// grid takes the fewest rounds of items, ceil(CTAs / SMs) waves of slabs / 3
// items a warpgroup.  More items a warpgroup overlap more loads with
// softmaxes; more CTAs fill the SMs at a small B*H (on the card: 24 at
// B=256 H=12 N=197, 6 at B=64 H=12 N=133 and N=20, PERF.md §6).
int slabs_for(int BH, int qtiles, int sms) {
  int best = 0;
  long best_rounds = 0;
  for (const int slabs : {3, 6, 12, 24}) {
    const long ctas = ((long)BH + slabs - 1) / slabs * qtiles;
    const long rounds = (ctas + sms - 1) / sms * (slabs / W);
    if (!best || rounds <= best_rounds) {
      best = slabs;
      best_rounds = rounds;
    }
  }
  return best;
}

template <int KT>
__global__ void __launch_bounds__(W * 128, 1)
attention_bhnd_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                      int BH, int N, int slabs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = smem_layout<W>(smem_raw);
  const int qtiles = (N + QROWS - 1) / QROWS;
  const int first = blockIdx.x / qtiles * slabs, q0 = (blockIdx.x % qtiles) * QROWS;
  const int end = min(BH, first + slabs);
  const int wg = threadIdx.x / 128;
  setup(sm, nullptr, 0, N);
  const int items = first + wg < end ? (end - 1 - first - wg) / W + 1 : 0;
  const ItemLoop<HeadSplit> L{{&q_map, &k_map, &v_map, out, N}, sm.rings + wg * RING,
                              sm.bars + wg * SLOTS, sm.key_row, q0, first + wg, W, items, scale};
  NoTurns turns;
  attend_items<KT>(L, turns);
}

template <int KT>
cudaError_t launch(const CUtensorMap (&maps)[3], void* out, int BH, int N, int slabs, int grid,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes(W);
  const cudaError_t e = cudaFuncSetAttribute(attention_bhnd_kernel<KT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attention_bhnd_kernel<KT><<<grid, W * 128, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), BH, N, slabs,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: [B, H, N, 64] bf16 contiguous, 16-byte aligned; BH = B * H.
// Launches on `stream` and returns the launch's error (0 = launched): shapes
// it does not take, a tensor map that does not encode, too much shared
// memory.
int clibd_attention_bhnd(const void* q, const void* k, const void* v, void* out, int BH, int N,
                         void* stream) {
  if (BH < 1 || N < 1 || N > MAX_N) return (int)cudaErrorInvalidValue;
  int max_smem = 0, dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int qtiles = (N + QROWS - 1) / QROWS;
  const int slabs = slabs_for(BH, qtiles, sms > 0 ? sms : 1);
  const long grid = ((long)BH + slabs - 1) / slabs * qtiles;
  if (smem_bytes(W) > max_smem || grid > 0x7fffffffL ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t e = encode_bf16_sw128(&maps[i], bases[i], N, HD, 64, BH);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kt_instance(N)) {
    case 2: return (int)launch<2>(maps, out, BH, N, slabs, (int)grid, s);
    case 4: return (int)launch<4>(maps, out, BH, N, slabs, (int)grid, s);
    case 9: return (int)launch<9>(maps, out, BH, N, slabs, (int)grid, s);
    case 13: return (int)launch<13>(maps, out, BH, N, slabs, (int)grid, s);
    default: return (int)launch<16>(maps, out, BH, N, slabs, (int)grid, s);
  }
}

const char* clibd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int clibd_flash_attention_max_n(void) { return MAX_N; }

}  // extern "C"
