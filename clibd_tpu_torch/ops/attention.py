"""Flash attention from the fused qkv tensor, forward and backward: the port
of `clibd_tpu/ops/pallas/attention.py::_flash_kernel`, `_flash_bwd_kernel`
and the custom VJP of `_make_flash`.

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
no fallback from the card to the plain version: a launch error raises.

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

Deliberately absent (TPU-only): `vmem_safe_block_b` (a model of the 16 MB
VMEM), `block_b` batch blocking, `_seq_pad`, `ATTN_BWD_GROUP` and the
`CLIBD_ATTN_NPAD16/PHASED/FWD_GROUP/FWD_BPHASE` statement-order knobs, and
the `CLIBD_ATTN_BWD=xla` switch (the plain backward is the CPU path).  The
out-projection fusion is not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

HEAD_DIM = 64  # the kernels' head width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIBS: dict = {}


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


def _library(name: str, fn: str, pointers: int, ints: int) -> ctypes.CDLL:
    """Build/load `csrc/<name>.cu` and declare its entry point `fn`, which
    takes `pointers` pointers, `ints` ints and the stream."""
    if name not in _LIBS:
        from .cuda_build import load_library

        lib = load_library(name)
        entry = getattr(lib, fn)
        entry.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
        lib.clibd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.clibd_cuda_error_string.restype = ctypes.c_char_p
        lib.clibd_flash_attention_max_n.argtypes = []
        lib.clibd_flash_attention_max_n.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def _check_cuda_args(what: str, lib, qkv: torch.Tensor, num_heads: int,
                     mask_row: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Raise on what the kernels do not take; → the mask as contiguous fp32."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {qkv.dtype} (bf16 or fp32 only)")
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) != num_heads * HEAD_DIM:
        raise ValueError(f"{what}: qkv {tuple(qkv.shape)} is not "
                         f"[B, N, 3*{num_heads}*{HEAD_DIM}] (head dim must be {HEAD_DIM})")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv must be contiguous and 16-byte aligned")
    B, N, _ = qkv.shape
    if N > lib.clibd_flash_attention_max_n():
        raise ValueError(f"{what}: N={N} exceeds the kernel's "
                         f"{lib.clibd_flash_attention_max_n()} keys")
    if mask_row is None:
        return None
    if mask_row.shape != (B, N) or mask_row.device != qkv.device:
        raise ValueError(f"{what}: mask {tuple(mask_row.shape)} on {mask_row.device} "
                         f"is not [{B}, {N}] on {qkv.device}")
    return mask_row.to(torch.float32).contiguous()


def _launch(what: str, lib, fn, pointers: list, B: int, N: int, num_heads: int,
            dtype: torch.dtype, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*pointers, B, N, num_heads, _DTYPE_CODE[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.clibd_cuda_error_string(rc).decode())


def flash_attention_qkv_cuda(qkv: torch.Tensor, num_heads: int,
                             mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel → ctx [B, N, D]."""
    lib = _library("flash_attention_qkv", "clibd_flash_attention_qkv_fwd", 3, 4)
    mask_row = _check_cuda_args("flash_attention_qkv", lib, qkv, num_heads, mask_row)
    B, N, three_d = qkv.shape
    out = torch.empty((B, N, three_d // 3), dtype=qkv.dtype, device=qkv.device)
    _launch("flash_attention_qkv", lib, lib.clibd_flash_attention_qkv_fwd,
            [qkv.data_ptr(), None if mask_row is None else mask_row.data_ptr(), out.data_ptr()],
            B, N, num_heads, qkv.dtype, qkv.device)
    flash_attention_qkv.launches += 1
    return out


def flash_attention_qkv_bwd_cuda(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                                 mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the backward kernel → dqkv [B, N, 3D].  dout is made
    contiguous here (autograd may hand over a strided gradient)."""
    lib = _library("flash_attention_qkv_bwd", "clibd_flash_attention_qkv_bwd", 4, 4)
    mask_row = _check_cuda_args("flash_attention_qkv_bwd", lib, qkv, num_heads, mask_row)
    B, N, three_d = qkv.shape
    dout = dout.to(qkv.dtype).contiguous()
    if dout.shape != (B, N, three_d // 3) or dout.device != qkv.device or dout.data_ptr() % 16:
        raise ValueError(f"flash_attention_qkv_bwd: dout {tuple(dout.shape)} on {dout.device} "
                         f"is not a 16-byte aligned [{B}, {N}, {three_d // 3}] on {qkv.device}")
    dqkv = torch.empty_like(qkv)
    _launch("flash_attention_qkv_bwd", lib, lib.clibd_flash_attention_qkv_bwd,
            [qkv.data_ptr(), dout.data_ptr(), None if mask_row is None else mask_row.data_ptr(),
             dqkv.data_ptr()], B, N, num_heads, qkv.dtype, qkv.device)
    flash_attention_qkv_bwd.launches += 1
    return dqkv


# What each direction runs on a CUDA tensor.  Module attributes, so that a
# measurement (`tools/profile_extract.plain_attention`) can send the
# operators to the plain versions on the card for a comparison.
_cuda_fwd = flash_attention_qkv_cuda
_cuda_bwd = flash_attention_qkv_bwd_cuda


@torch.library.custom_op("clibd::flash_attention_qkv_fwd", mutates_args=())
def _fwd_op(qkv: torch.Tensor, mask_row: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return flash_attention_qkv_reference(qkv, num_heads, mask_row)
    return _cuda_fwd(qkv, num_heads, mask_row)


@_fwd_op.register_fake
def _(qkv, mask_row, num_heads):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))


@torch.library.custom_op("clibd::flash_attention_qkv_bwd", mutates_args=())
def _bwd_op(qkv: torch.Tensor, dout: torch.Tensor, mask_row: Optional[torch.Tensor],
            num_heads: int) -> torch.Tensor:
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


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention from the fused qkv tensor → ctx [B, N, D],
    differentiable with respect to qkv."""
    return _fwd_op(qkv, mask_row, num_heads)


def flash_attention_qkv_bwd(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                            mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward alone: dqkv [B, N, 3D] from (qkv, dO)."""
    return _bwd_op(qkv, dout, mask_row, num_heads)


# launches of each kernel, counted where the wrapper launches it
flash_attention_qkv.launches = 0
flash_attention_qkv_bwd.launches = 0
