"""Flash attention from the fused qkv tensor, forward and backward, and the
attention with its out-projection fused in: the port of
`clibd_tpu/ops/pallas/attention.py::_flash_kernel`, `_flash_bwd_kernel`,
`_flash_outproj_kernel` and the custom VJPs of `_make_flash` and
`_make_flash_outproj`.

`flash_attention_qkv(qkv, num_heads, mask_row)` takes qkv [B, N, 3D] (bias
and any LoRA deltas already added) and an optional [B, N] additive fp32 key
mask, and returns ctx [B, N, D] in qkv's dtype.  It is differentiable with
respect to qkv (the mask gets no gradient): the forward and the backward are
registered operators, `clibd::flash_attention_qkv_fwd` and
`clibd::flash_attention_qkv_bwd`, so selective activation checkpointing
(`models/layers.py`) can see the forward and save its output.  The backward
saves qkv and the mask and recomputes P, as the TPU kernel does.

On a CUDA tensor each direction launches its hand-written kernel
(`csrc/flash_attention_qkv.cu`, `csrc/flash_attention_qkv_bwd.cu`); on a CPU
tensor it runs its plain version (`flash_attention_qkv_reference`,
`flash_attention_qkv_bwd_reference`), which has the same numerics.  There is
no fallback from the card to the plain version: a launch error raises.  The
kernels take any N, as the TPU package does.  The bf16 forward kernel uses
an online softmax and rounds P to bf16 before dividing by the row sum (one
bf16 rounding of P away from the numerics below, within the tolerance
`chip_smoke.py` holds it to).  The bf16 backward takes one of two routes by
N, a rule its library holds (`flash_attention_qkv_bwd_route`, read from
`clibd_flash_bwd_route`), every product on `wgmma` fed by TMA: up to 208
keys the whole row of a (batch, head) on chip (`csrc/wgmma_attention_bwd.cuh`:
S and dP once, the exact softmax in registers, Pb and dS in shared memory,
5 products, one exp pass); past them key-tiled in two kernels (9 products,
three exp passes): a row kernel per 64-row query tile sweeps the keys once
for each row's max, sum and rowsum(P * dP), then again for dQ, and a
key-major column kernel per 64-key block forms dK and dV.  No two CTAs
write the same output and nothing is added atomically, so the same inputs
give the same bits.

Forward numerics (the TPU kernel's, `attention.py:126-208`): S = q.k^T in
fp32 times 1/sqrt(hd), plus the mask, fp32 softmax, P rounded to bf16 after
the normalisation, V rounded to bf16, P.V accumulated in fp32, output cast to
qkv's dtype.  Backward numerics (`attention.py:229-310`): the same S and fp32
P, Pb = bf16(P); dO, V, K and Q rounded to bf16 even for fp32 inputs;
dV = Pb^T.dO and dP = dO.V^T accumulated in fp32;
dS = bf16(P * (dP - rowsum(P * dP)) * scale) with the fp32 P; dQ = dS.K and
dK = dS^T.Q accumulated in fp32; all three written into the fused layout in
qkv's dtype.  The port never pads N in device memory, so every key is real
and the TPU kernels' -inf pad columns have no counterpart; a fully masked row
still comes out uniform over its keys, because every masked score equals
finfo(float32).min.

`flash_attention_qkv_outproj(qkv, out_w, out_b, num_heads, mask_row)` is the
attention followed by ctx . out_w + out_b in one operator,
`clibd::flash_attention_qkv_outproj` (`csrc/flash_attention_qkv_outproj.cu`
on a CUDA tensor, `flash_attention_qkv_outproj_reference` on a CPU tensor):
ctx rounded to bf16, W_out read as bf16 and the bias as fp32, products
accumulated in fp32, even for fp32 qkv.  The bf16 kernel takes 2, 4, 6, 8 or
12 heads, the fp32 kernel any D that is a multiple of 128; both read W_out as
it is, [D_in, D_out] (the bf16 kernel's `wgmma` products take it as an
MN-major operand, so nothing is transposed).  Its backward is the TPU package's
default one (`CLIBD_ATTN_BWD=pallas`): dctx = g . W_out^T into the backward
kernel, ctx recomputed by the forward kernel for dW.

`attention_bhnd(q, k, v)` is attention from separate q, k, v [B, H, N, 64]
bf16 → [B, H, N, 64] in q's dtype, no mask: the port of the experiment
`tools/exp_attn.py::make_pallas_attn` (`:125-162`), with the forward
kernel's numerics (S in fp32 times hd^-1/2, fp32 row softmax, P rounded to
bf16 after the normalisation, P.V accumulated in fp32).  On a CUDA tensor it
launches `csrc/attention_bhnd.cu`, on a CPU tensor it runs
`attention_bhnd_reference`; it has no backward.  The TPU script pads N to
128 * ceil(N / 128) in device memory and gives the pad keys -1e30: their
weights come out exactly 0, so the port pads nothing and masks the keys
past N inside the kernel.  `make_pallas_attn`'s `np_pad` and `fuse_heads`
arguments are unused in the JAX code itself and have no counterpart, nor
has its batch block `bb` (here a CTA walks a group of (batch, head) slabs
for 64 query rows, on the `wgmma` core of the experiment forwards).

`flash_attention_qkv_phased`, `flash_attention_qkv_batched` and
`flash_attention_qkv_bwd_phased` are the ports of the experiment kernels of
`tools/exp_flash.py` (`_phased_kernel`, `_batched_kernel`,
`_phased_bwd_kernel`): the forward and the backward above in other
schedules.  The two forwards share one `wgmma` attention core
(`csrc/wgmma_attention.cuh`: a warpgroup attends 64 query rows of a head
over the whole row of keys, S and P.V on `wgmma` with P from registers, K
and V by TMA into the warpgroup's own ring) and differ in the loop around
it: `csrc/flash_attention_qkv_phased.cu` runs a CTA per (batch, G heads, 64
query rows) whose warpgroups issue their products in turns, so one
warpgroup's softmax runs while the next one's products are in flight;
`csrc/flash_attention_qkv_batched.cu` a CTA per (batch, 64 query rows) whose
three warpgroups walk every head free of each other.  Both take N <= 256
and, unlike the bf16 forward kernel above, round P to bf16 after the
normalisation, as the numerics below do.  `csrc/flash_attention_qkv_bwd_phased.cu`
is the entry point of the whole-row backward core that the backward above
runs up to 208 keys (`csrc/wgmma_attention_bwd.cuh`): Pb and dS of a
(batch, head) in shared memory so S is computed once, a CTA per (batch,
head) of one warpgroup (N <= 64) or two, every product on `wgmma` with
its operands loaded by TMA (a row phase of 64-query blocks: S, the
softmax, dP in 64-key chunks, dQ; then a column phase of 64-key blocks: dV
and dK from Pb and dS read transposed).  Each computes what its JAX variant does, so its plain
version is the forward's or the backward's (`flash_attention_qkv_reference`,
`flash_attention_qkv_bwd_reference`), and a CPU tensor runs that.  They
take bf16 only (TypeError otherwise), have no autograd (the JAX variants
have none) and are used by nothing but the experiment harness
`tools/exp_flash.py`.  `heads_per_phase` is the phased kernel's G (1, 2, 3,
4, 6, 8 or 12 dividing H): None takes the largest that fits the card's
shared memory (every G fits, so H where H is one of those), 0 all the
heads; the wrapper asks the library what a G needs and raises before
launching when it does not fit.  The backward takes N <= 208 (its Pb and dS
fill the shared memory there).  The JAX script's batch block `block_b` has
no counterpart: the grids run over batch elements and query tiles.

Deliberately absent (TPU-only): `vmem_safe_block_b` (a model of the 16 MB
VMEM), `block_b` batch blocking, `_seq_pad`, `ATTN_BWD_GROUP` and the
`CLIBD_ATTN_NPAD16/PHASED/FWD_GROUP/FWD_BPHASE` statement-order knobs, and
the `CLIBD_ATTN_BWD=xla` switch (the plain backward is the CPU path).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..utils.profiling import span
from .cuda_build import DTYPE_CODE, function, launch

HEAD_DIM = 64  # the kernels' head width


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, D = t.shape
    return t.reshape(B, N, num_heads, D // num_heads).transpose(1, 2)


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float,
           mask_row: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 softmax of q.k^T * scale + mask, q/k [B, H, N, hd]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask_row is not None:
        s = s + mask_row.float()[:, None, None, :]
    return torch.softmax(s, dim=-1)


def flash_attention_qkv_reference(qkv: torch.Tensor, num_heads: int,
                                  mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (the counterpart of
    `clibd_tpu.ops.pallas.attention._xla_attention_from_qkv`)."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    q, k, v = (_heads(t, num_heads) for t in qkv.split(D, dim=-1))
    p = _probs(q, k, 1.0 / math.sqrt(D // num_heads), mask_row).to(torch.bfloat16)
    ctx = torch.matmul(p.float(), v.to(torch.bfloat16).float())
    return ctx.transpose(1, 2).reshape(B, N, D).to(qkv.dtype)


def flash_attention_qkv_bwd_reference(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                                      mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: (qkv, dO [B, N, D]) →
    dqkv [B, N, 3D] in qkv's dtype, step by step as `_flash_bwd_kernel`.
    bf16 values are multiplied as fp32, which is exact, so each matmul here
    is a bf16 product accumulated in fp32."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    scale = 1.0 / math.sqrt(D // num_heads)
    q, k, v = (_heads(t, num_heads) for t in qkv.split(D, dim=-1))
    p = _probs(q, k, scale, mask_row)                               # fp32 P
    pb = p.to(torch.bfloat16).float()
    do = _heads(dout, num_heads).to(torch.bfloat16).float()
    dv = torch.matmul(pb.transpose(-1, -2), do)
    dp = torch.matmul(do, v.to(torch.bfloat16).float().transpose(-1, -2))
    row = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - row) * scale).to(torch.bfloat16).float()
    dq = torch.matmul(ds, k.to(torch.bfloat16).float())
    dk = torch.matmul(ds.transpose(-1, -2), q.to(torch.bfloat16).float())
    parts = [t.transpose(1, 2).reshape(B, N, D) for t in (dq, dk, dv)]
    return torch.cat(parts, dim=-1).to(qkv.dtype)


def flash_attention_qkv_outproj_reference(qkv: torch.Tensor, out_w: torch.Tensor,
                                          out_b: torch.Tensor, num_heads: int,
                                          mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the fused attention + out-projection kernel:
    the forward kernel's plain version, ctx rounded to bf16, then
    ctx . bf16(W_out) accumulated in fp32 plus the fp32 bias, cast to qkv's
    dtype (`attention.py:555-559`).  bf16 ctx even for fp32 qkv, as the TPU
    kernel's bf16 scratch holds it."""
    ctx = flash_attention_qkv_reference(qkv, num_heads, mask_row).to(torch.bfloat16)
    y = torch.matmul(ctx.float(), out_w.to(torch.bfloat16).float()) + out_b.float()
    return y.to(qkv.dtype)


def _check_cuda_args(what: str, qkv: torch.Tensor, num_heads: int,
                     mask_row: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Raise on what the kernels do not take; → the mask as contiguous fp32."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {qkv.device}")
    if qkv.dtype not in DTYPE_CODE:
        raise TypeError(f"{what}: dtype {qkv.dtype} (bf16 or fp32 only)")
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) != num_heads * HEAD_DIM:
        raise ValueError(f"{what}: qkv {tuple(qkv.shape)} is not "
                         f"[B, N, 3*{num_heads}*{HEAD_DIM}] (head dim must be {HEAD_DIM})")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv must be contiguous and 16-byte aligned")
    B, N, _ = qkv.shape
    if mask_row is None:
        return None
    if mask_row.shape != (B, N) or mask_row.device != qkv.device:
        raise ValueError(f"{what}: mask {tuple(mask_row.shape)} on {mask_row.device} "
                         f"is not [{B}, {N}] on {qkv.device}")
    return mask_row.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_qkv_cuda(qkv: torch.Tensor, num_heads: int,
                             mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel → ctx [B, N, D]."""
    mask_row = _check_cuda_args("flash_attention_qkv", qkv, num_heads, mask_row)
    B, N, three_d = qkv.shape
    out = torch.empty((B, N, three_d // 3), dtype=qkv.dtype, device=qkv.device)
    launch("flash_attention_qkv", "flash_attention_qkv", "clibd_flash_attention_qkv_fwd",
           [qkv.data_ptr(), _ptr(mask_row), out.data_ptr()],
           [B, N, num_heads, DTYPE_CODE[qkv.dtype]], qkv.device)
    flash_attention_qkv.launches += 1
    return out


def flash_attention_qkv_bwd_route(N: int) -> int:
    """The bf16 backward kernel's route at N keys, as its library picks it
    (`clibd_flash_bwd_route`): 0, the whole row of a (batch, head) on chip
    (N <= 208); 1, key-tiled (any N)."""
    return function("flash_attention_qkv_bwd", "clibd_flash_bwd_route", [ctypes.c_int])(N)


def flash_attention_qkv_bwd_cuda(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                                 mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the backward kernels → dqkv [B, N, 3D]: for bf16 the route
    `flash_attention_qkv_bwd_route(N)` names (the whole-row kernel, or the
    key-tiled row-statistics and column kernels), for fp32 the SIMT row and
    column kernels, with the scratch they need allocated here.  One call
    counts as one launch of `flash_attention_qkv_bwd`, as one backward of
    the operator.  dout is made contiguous here (autograd may hand over a
    strided gradient)."""
    what = "flash_attention_qkv_bwd"
    mask_row = _check_cuda_args(what, qkv, num_heads, mask_row)
    B, N, three_d = qkv.shape
    dout = dout.to(qkv.dtype).contiguous()
    if dout.shape != (B, N, three_d // 3) or dout.device != qkv.device or dout.data_ptr() % 16:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} on {dout.device} "
                         f"is not a 16-byte aligned [{B}, {N}, {three_d // 3}] on {qkv.device}")
    code = DTYPE_CODE[qkv.dtype]
    route = flash_attention_qkv_bwd_route(N) if qkv.dtype == torch.bfloat16 else 0
    nbytes = function(what, "clibd_flash_bwd_scratch_bytes", [ctypes.c_int] * 5,
                      ctypes.c_long)(B, N, num_heads, code, route)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    launch(what, what, "clibd_flash_attention_qkv_bwd",
           [qkv.data_ptr(), dout.data_ptr(), _ptr(mask_row), dqkv.data_ptr(),
            scratch.data_ptr() if nbytes else None],
           [B, N, num_heads, code, route], qkv.device)
    flash_attention_qkv_bwd.launches += 1
    return dqkv


def flash_attention_qkv_outproj_cuda(qkv: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
                                     num_heads: int,
                                     mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the fused attention + out-projection kernel → [B, N, D].  W_out
    goes to the kernel as bf16 and the bias as fp32, as the TPU kernel reads
    them."""
    what = "flash_attention_qkv_outproj"
    mask_row = _check_cuda_args(what, qkv, num_heads, mask_row)
    B, N, three_d = qkv.shape
    D = three_d // 3
    if out_w.shape != (D, D) or out_b.shape != (D,) or out_w.device != qkv.device \
            or out_b.device != qkv.device:
        raise ValueError(f"{what}: out_w {tuple(out_w.shape)} / out_b {tuple(out_b.shape)} on "
                         f"{out_w.device} are not [{D}, {D}] / [{D}] on {qkv.device}")
    code = DTYPE_CODE[qkv.dtype]
    smem = function(what, "clibd_flash_outproj_smem_bytes", [ctypes.c_int] * 3,
                    ctypes.c_long)(N, num_heads, code)
    _check_smem(what, smem, smem_limit(qkv.device),
                f"N={N}, {num_heads} heads, {qkv.dtype} (bf16 takes 2, 4, 6, 8 or 12 heads; fp32 "
                "a D that is a multiple of 128)")
    w = out_w.to(torch.bfloat16).contiguous()
    b = out_b.to(torch.float32).contiguous()
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    launch(what, what, "clibd_flash_attention_qkv_outproj",
           [qkv.data_ptr(), _ptr(mask_row), w.data_ptr(), b.data_ptr(), out.data_ptr()],
           [B, N, num_heads, code], qkv.device)
    flash_attention_qkv_outproj.launches += 1
    return out


def _check_bf16_args(what: str, qkv: torch.Tensor, num_heads: int,
                     mask_row: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """`_check_cuda_args` for the kernels that take bf16 only."""
    if qkv.device.type == "cuda" and qkv.dtype != torch.bfloat16:
        raise TypeError(f"{what}: dtype {qkv.dtype} (bf16 only)")
    return _check_cuda_args(what, qkv, num_heads, mask_row)


def smem_limit(device) -> int:
    """Shared memory a CTA may opt in to on the card."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def _check_smem(what: str, smem: int, limit: int, shapes: str) -> None:
    if not 0 < smem <= limit:
        raise ValueError(f"{what}: {shapes} needs {smem or 'an unsupported amount of'} bytes of "
                         f"shared memory, the card gives {limit}")


def phased_smem_bytes(N: int, num_heads: int, heads_per_phase: int) -> int:
    """Shared memory a launch of the phased forward kernel at (N, H, G)
    needs, as its library computes it; 0 where the kernel does not take the
    shapes (G not one of 1, 2, 3, 4, 6, 8, 12 dividing H, or N above 256)."""
    return function("flash_attention_qkv_phased", "clibd_flash_phased_smem_bytes",
                    [ctypes.c_int] * 3, ctypes.c_long)(N, num_heads, heads_per_phase)


def phased_heads(N: int, num_heads: int, heads_per_phase: Optional[int], limit: int) -> int:
    """The phased kernel's G: `heads_per_phase`, with 0 meaning all the
    heads, or for None the largest G whose shared memory fits `limit`."""
    if heads_per_phase is not None:
        return heads_per_phase or num_heads
    for G in range(num_heads, 0, -1):
        if 0 < phased_smem_bytes(N, num_heads, G) <= limit:
            return G
    raise ValueError(f"flash_attention_qkv_phased: no head group fits N={N} in {limit} bytes")


def _check_heads_per_phase(num_heads: int, heads_per_phase: Optional[int]) -> None:
    if heads_per_phase is not None and (heads_per_phase < 0 or
                                        (heads_per_phase and num_heads % heads_per_phase)):
        raise ValueError(f"flash_attention_qkv_phased: {heads_per_phase} heads per phase do not "
                         f"divide {num_heads} heads")


def flash_attention_qkv_phased_cuda(qkv: torch.Tensor, num_heads: int,
                                    mask_row: Optional[torch.Tensor] = None,
                                    heads_per_phase: Optional[int] = None) -> torch.Tensor:
    """Launch the phased forward kernel → ctx [B, N, D]."""
    what = "flash_attention_qkv_phased"
    _check_heads_per_phase(num_heads, heads_per_phase)
    mask_row = _check_bf16_args(what, qkv, num_heads, mask_row)
    B, N, three_d = qkv.shape
    limit = smem_limit(qkv.device)
    G = phased_heads(N, num_heads, heads_per_phase, limit)
    _check_smem(what, phased_smem_bytes(N, num_heads, G), limit,
                f"N={N} with {G} of {num_heads} heads per phase")
    out = torch.empty((B, N, three_d // 3), dtype=qkv.dtype, device=qkv.device)
    launch(what, what, "clibd_flash_attention_qkv_phased",
           [qkv.data_ptr(), _ptr(mask_row), out.data_ptr()], [B, N, num_heads, G], qkv.device)
    flash_attention_qkv_phased.launches += 1
    return out


def flash_attention_qkv_batched_cuda(qkv: torch.Tensor, num_heads: int,
                                     mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the batched forward kernel → ctx [B, N, D]."""
    what = "flash_attention_qkv_batched"
    mask_row = _check_bf16_args(what, qkv, num_heads, mask_row)
    B, N, three_d = qkv.shape
    smem = function(what, "clibd_flash_batched_smem_bytes", [ctypes.c_int] * 2,
                    ctypes.c_long)(N, num_heads)
    _check_smem(what, smem, smem_limit(qkv.device), f"N={N} with {num_heads} heads")
    out = torch.empty((B, N, three_d // 3), dtype=qkv.dtype, device=qkv.device)
    launch(what, what, "clibd_flash_attention_qkv_batched",
           [qkv.data_ptr(), _ptr(mask_row), out.data_ptr()], [B, N, num_heads], qkv.device)
    flash_attention_qkv_batched.launches += 1
    return out


def flash_attention_qkv_bwd_phased_cuda(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                                        mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the phased backward kernel → dqkv [B, N, 3D]."""
    what = "flash_attention_qkv_bwd_phased"
    mask_row = _check_bf16_args(what, qkv, num_heads, mask_row)
    B, N, three_d = qkv.shape
    dout = dout.to(qkv.dtype).contiguous()
    if dout.shape != (B, N, three_d // 3) or dout.device != qkv.device or dout.data_ptr() % 16:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} on {dout.device} is not a 16-byte "
                         f"aligned [{B}, {N}, {three_d // 3}] on {qkv.device}")
    smem = function(what, "clibd_flash_bwd_phased_smem_bytes", [ctypes.c_int], ctypes.c_long)(N)
    _check_smem(what, smem, smem_limit(qkv.device), f"N={N} (it takes N <= 208)")
    dqkv = torch.empty_like(qkv)
    launch(what, what, "clibd_flash_attention_qkv_bwd_phased",
           [qkv.data_ptr(), dout.data_ptr(), _ptr(mask_row), dqkv.data_ptr()],
           [B, N, num_heads], qkv.device)
    flash_attention_qkv_bwd_phased.launches += 1
    return dqkv


def flash_attention_qkv_phased(qkv: torch.Tensor, num_heads: int,
                               mask_row: Optional[torch.Tensor] = None,
                               heads_per_phase: Optional[int] = None) -> torch.Tensor:
    """The forward phased across groups of `heads_per_phase` heads → ctx
    [B, N, D]: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if qkv.device.type == "cpu":
        _check_heads_per_phase(num_heads, heads_per_phase)
        return flash_attention_qkv_reference(qkv, num_heads, mask_row)
    return flash_attention_qkv_phased_cuda(qkv, num_heads, mask_row, heads_per_phase)


def flash_attention_qkv_batched(qkv: torch.Tensor, num_heads: int,
                                mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward with every head of a query tile in one CTA → ctx
    [B, N, D]: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if qkv.device.type == "cpu":
        return flash_attention_qkv_reference(qkv, num_heads, mask_row)
    return flash_attention_qkv_batched_cuda(qkv, num_heads, mask_row)


def flash_attention_qkv_bwd_phased(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                                   mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward with Pb and dS kept on chip → dqkv [B, N, 3D]: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return flash_attention_qkv_bwd_reference(qkv, dout, num_heads, mask_row)
    return flash_attention_qkv_bwd_phased_cuda(qkv, dout, num_heads, mask_row)


def attention_bhnd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the separate-q/k/v kernel, q, k, v
    [B, H, N, hd]: bf16 values multiplied in fp32 (exact products)."""
    p = _probs(q, k, 1.0 / math.sqrt(q.shape[-1]), None).to(torch.bfloat16)
    return torch.matmul(p.float(), v.to(torch.bfloat16).float()).to(q.dtype)


def attention_bhnd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the separate-q/k/v kernel → o [B, H, N, 64] in q's dtype."""
    what = "attention_bhnd"
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: no kernel for q, k, v on {q.device}, {k.device}, {v.device}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q {q.dtype}, k {k.dtype}, v {v.dtype} (bf16 only)")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"are not one [B, H, N, {HEAD_DIM}] (head dim must be {HEAD_DIM})")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: q, k and v must be contiguous and 16-byte aligned")
    B, H, N, _ = q.shape
    max_n = function(what, "clibd_flash_attention_max_n", [])()
    if N > max_n:
        raise ValueError(f"{what}: N={N} exceeds the kernel's {max_n} keys")
    out = torch.empty_like(q)
    launch(what, what, "clibd_attention_bhnd",
           [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()], [B * H, N], q.device)
    attention_bhnd.launches += 1
    return out


def attention_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q.k^T / sqrt(hd)).v from separate q, k, v [B, H, N, 64]: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return attention_bhnd_reference(q, k, v)
    return attention_bhnd_cuda(q, k, v)


# What each operator runs on a CUDA tensor.  Module attributes, so that a
# measurement (`tools/profile_extract.plain_kernels`) can send the operators
# to the plain versions on the card for a comparison.
_cuda_fwd = flash_attention_qkv_cuda
_cuda_bwd = flash_attention_qkv_bwd_cuda
_cuda_outproj = flash_attention_qkv_outproj_cuda


@torch.library.custom_op("clibd::flash_attention_qkv_fwd", mutates_args=())
def _fwd_op(qkv: torch.Tensor, mask_row: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    with span("attn.fwd"):
        if qkv.device.type == "cpu":
            return flash_attention_qkv_reference(qkv, num_heads, mask_row)
        return _cuda_fwd(qkv, num_heads, mask_row)


@_fwd_op.register_fake
def _(qkv, mask_row, num_heads):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))


@torch.library.custom_op("clibd::flash_attention_qkv_bwd", mutates_args=())
def _bwd_op(qkv: torch.Tensor, dout: torch.Tensor, mask_row: Optional[torch.Tensor],
            num_heads: int) -> torch.Tensor:
    with span("attn.bwd"):
        if qkv.device.type == "cpu":
            return flash_attention_qkv_bwd_reference(qkv, dout, num_heads, mask_row)
        return _cuda_bwd(qkv, dout, num_heads, mask_row)


@_bwd_op.register_fake
def _(qkv, dout, mask_row, num_heads):
    return torch.empty_like(qkv)


def _setup_context(ctx, inputs, output):
    qkv, mask_row, num_heads = inputs
    ctx.save_for_backward(qkv, mask_row)
    ctx.num_heads = num_heads


def _backward(ctx, grad):
    qkv, mask_row = ctx.saved_tensors
    return _bwd_op(qkv, grad, mask_row, ctx.num_heads), None, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)


@torch.library.custom_op("clibd::flash_attention_qkv_outproj", mutates_args=())
def _outproj_op(qkv: torch.Tensor, mask_row: Optional[torch.Tensor], out_w: torch.Tensor,
                out_b: torch.Tensor, num_heads: int) -> torch.Tensor:
    with span("attn.outproj"):
        if qkv.device.type == "cpu":
            return flash_attention_qkv_outproj_reference(qkv, out_w, out_b, num_heads, mask_row)
        return _cuda_outproj(qkv, out_w, out_b, num_heads, mask_row)


@_outproj_op.register_fake
def _(qkv, mask_row, out_w, out_b, num_heads):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))


def _outproj_setup_context(ctx, inputs, output):
    qkv, mask_row, out_w, out_b, num_heads = inputs
    ctx.save_for_backward(qkv, mask_row, out_w, out_b)
    ctx.num_heads = num_heads


def _mm_fp32_acc(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a.b of bf16 operands accumulated in fp32, returned in `dtype`: a bf16
    GEMM where the result is bf16 anyway, else a product of the bf16 values
    in fp32 (exact products)."""
    if dtype == torch.bfloat16:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(dtype)


def _outproj_backward(ctx, grad):
    """`attention.py:536-553` (the default `CLIBD_ATTN_BWD=pallas`): dctx =
    bf16(g).bf16(W_out)^T into the backward kernel; ctx recomputed by the
    forward kernel for dW = bf16(ctx)^T.bf16(g); db = sum of g in fp32.  The
    three products are plain GEMMs, as they are outside any Pallas kernel."""
    qkv, mask_row, out_w, out_b = ctx.saved_tensors
    D = out_w.shape[0]
    gb = grad.to(torch.bfloat16)
    dctx = _mm_fp32_acc(gb, out_w.to(torch.bfloat16).t(), qkv.dtype)
    dqkv = _bwd_op(qkv, dctx, mask_row, ctx.num_heads)
    c = _fwd_op(qkv, mask_row, ctx.num_heads).to(torch.bfloat16)
    dw = _mm_fp32_acc(c.reshape(-1, D).t(), gb.reshape(-1, D), out_w.dtype)
    db = grad.float().sum(dim=(0, 1)).to(out_b.dtype)
    return dqkv, None, dw, db, None


_outproj_op.register_autograd(_outproj_backward, setup_context=_outproj_setup_context)


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention from the fused qkv tensor → ctx [B, N, D],
    differentiable with respect to qkv."""
    return _fwd_op(qkv, mask_row, num_heads)


def flash_attention_qkv_bwd(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                            mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward alone: dqkv [B, N, 3D] from (qkv, dO)."""
    return _bwd_op(qkv, dout, mask_row, num_heads)


def flash_attention_qkv_outproj(qkv: torch.Tensor, out_w: torch.Tensor, out_b: torch.Tensor,
                                num_heads: int,
                                mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention + out-projection from the fused qkv tensor:
    attention(qkv) . out_w + out_b → [B, N, D] in qkv's dtype, with out_w
    [D, D] ([in, out]) and out_b [D]; the context never exists in device
    memory.  Differentiable with respect to qkv, out_w and out_b."""
    return _outproj_op(qkv, mask_row, out_w, out_b, num_heads)


# launches of each kernel, counted where the wrapper launches it
flash_attention_qkv.launches = 0
flash_attention_qkv_bwd.launches = 0
flash_attention_qkv_outproj.launches = 0
attention_bhnd.launches = 0
flash_attention_qkv_phased.launches = 0
flash_attention_qkv_batched.launches = 0
flash_attention_qkv_bwd_phased.launches = 0
