"""LayerNorm over the last dimension as one kernel forward and one backward.

`layernorm(x, scale, bias, eps, fast)` is the port's LayerNorm (the
counterpart of `clibd_tpu/models/layers.py::layernorm`), which every tower
calls through `models/layers.py`.  On a CPU tensor it runs the plain
version, `layernorm_reference`, and autograd through it.  On a CUDA tensor
it runs the registered operator `clibd::layernorm`, which launches the
hand-written kernel (`csrc/layernorm.cu`) forward, returning the output and
the row mean and inverse std the normalisation used, and whose registered
backward launches the backward kernel (`layernorm_bwd`).  There is no
fallback from the card to the plain version: a build or launch error
raises.  The operator runs on a CPU tensor too (`layernorm_stats_reference`
and `layernorm_bwd_reference`), so its autograd can be tested without a
card.

Numerics.  Exact path (fp32 x, or fast=False): fp32 throughout, the output
cast to x's dtype.  fast=True on a non-fp32 x: mean and variance accumulate
in fp32; the mean, x - mean, the inverse std and each of the normalise,
scale and bias steps are rounded to x's dtype (`layers.py:121-139`).  The
kernel rounds at the same points, so its output equals the plain version's
but where the fp32 sums' order differs.  The backward is the analytic
gradient in fp32 (`layernorm_bwd_reference`) from x and the saved row
statistics (8 bytes a row), dx rounded once to x's dtype, dscale and dbias
fp32 sums over the rows in a fixed order: two launches on the same inputs
give the same bits.  Autograd through the plain fast path rounds its
intermediate gradients to bf16 on the way, so the two backward paths agree
to bf16 rounding, not bit for bit.

Under the selective remat policies (`models/layers.py::remat_policy`) the
operator is untagged, so the backward recomputes it like any other
untagged op.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .cuda_build import DTYPE_CODE, function, launch


def _reference_parts(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                     fast: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, inv) of the plain version, mean and inv [..., 1] as its
    normalisation used them."""
    if fast and x.dtype != torch.float32:
        mean = x.float().mean(dim=-1, keepdim=True).to(x.dtype)
        xc = x - mean
        var = xc.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return xc * inv * scale.to(x.dtype) + bias.to(x.dtype), mean, inv
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = (x32 - mean) * inv
    return (y * scale + bias).to(x.dtype), mean, inv


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-12, fast: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  Exact path: fp32 throughout.
    fast=True (non-fp32 inputs only): mean and variance accumulate in fp32,
    the normalise/scale arithmetic stays in x's dtype (`layers.py:121-139`)."""
    return _reference_parts(x, scale, bias, eps, fast)[0]


def layernorm_stats_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              eps: float = 1e-12, fast: bool = False):
    """The forward kernel's three outputs by the plain version: y, and the
    row mean and inverse std [...] in fp32 as the normalisation used them
    (rounded to x's dtype on the fast path)."""
    y, mean, inv = _reference_parts(x, scale, bias, eps, fast)
    return y, mean.float().squeeze(-1), inv.float().squeeze(-1)


def layernorm_bwd_reference(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor, fast: bool = False):
    """Plain PyTorch version of the backward kernel, the analytic LayerNorm
    gradient in fp32 from x, dy, the scale and the forward's row statistics:
    xhat = (x - mean) * rstd, g = dy * scale (fast: the scale rounded to x's
    dtype, as the forward used it), dx = rstd * (g - mean(g) - xhat *
    mean(g * xhat)) rounded to x's dtype; dscale = sum over rows of dy *
    xhat, dbias = sum of dy, in fp32, cast to the scale's dtype."""
    s = scale.to(x.dtype).float() if fast and x.dtype != torch.float32 else scale.float()
    xhat = (x.float() - mean[..., None]) * rstd[..., None]
    g = dy.float() * s
    mg = g.mean(dim=-1, keepdim=True)
    mgx = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd[..., None] * (g - mg - xhat * mgx)).to(x.dtype)
    rows = tuple(range(x.dim() - 1))
    dscale = (dy.float() * xhat).sum(dim=rows).to(scale.dtype)
    dbias = dy.float().sum(dim=rows).to(scale.dtype)
    return dx, dscale, dbias


def _rows(what: str, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x [..., D] → (x as rows [R, D] with unit column stride, the row
    stride in elements): a view where x's layout allows one (the ViT's class
    row x[:, 0] is one), else a contiguous copy."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"{what}: dtype {x.dtype} (bf16 or fp32 only)")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"{what}: x {tuple(x.shape)} has no last dimension to normalise")
    D = x.shape[-1]
    rows = x.reshape(-1, D)
    stride = rows.stride(0) if rows.shape[0] > 1 else D
    if rows.stride(1) != 1 or stride < D:
        rows, stride = rows.contiguous(), D
    if rows.shape[0] >= 2 ** 31 or stride >= 2 ** 31:
        raise ValueError(f"{what}: x {tuple(x.shape)} has 2^31 rows or a row stride of 2^31 "
                         "elements or more")
    return rows, stride


def _param(what: str, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [D] parameter as a 16-byte aligned fp32 vector on x's device."""
    if p.shape != (x.shape[-1],):
        raise ValueError(f"{what}: parameter {tuple(p.shape)} is not [{x.shape[-1]}]")
    p = p.to(device=x.device, dtype=torch.float32).contiguous()
    return p if p.data_ptr() % 16 == 0 else p.clone()


def layernorm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                   fast: bool):
    """Launch the forward kernel on x [..., D] → (y of x's shape and dtype,
    contiguous; mean and rstd [...] fp32)."""
    what = "layernorm"
    rows, stride = _rows(what, x)
    R, D = rows.shape
    fast = fast and x.dtype != torch.float32
    y = torch.empty((R, D), dtype=x.dtype, device=x.device)
    mean, rstd = (torch.empty(R, dtype=torch.float32, device=x.device) for _ in range(2))
    if R:
        # the parameters held until the launch: a freed copy's block could be
        # handed to the next allocation before the kernel reads it
        scale, bias = _param(what, scale, x), _param(what, bias, x)
        launch(what, what, "clibd_layernorm_fwd",
               [rows.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr()],
               [R, D, stride, DTYPE_CODE[x.dtype], int(fast)], x.device, floats=[eps])
        layernorm.launches += 1
    lead = x.shape[:-1]
    return y.reshape(*lead, D), mean.reshape(lead), rstd.reshape(lead)


def layernorm_bwd_cuda(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor, fast: bool = False):
    """Launch the backward kernels → (dx of x's shape and dtype, dscale and
    dbias [D] of the scale's dtype).  One call counts as one launch of
    `layernorm_bwd`: the row kernel and the ordered sum of the parameter
    gradients' partials."""
    what = "layernorm_bwd"
    rows, stride = _rows(what, x)
    R, D = rows.shape
    fast = fast and x.dtype != torch.float32
    dy = dy.to(x.dtype).reshape(R, D).contiguous()
    stats = [t.to(device=x.device, dtype=torch.float32).reshape(R).contiguous()
             for t in (mean, rstd)]
    dx = torch.empty((R, D), dtype=x.dtype, device=x.device)
    grads = (torch.empty if R else torch.zeros)((2, D), dtype=torch.float32, device=x.device)
    if R:
        nbytes = function("layernorm", "clibd_layernorm_bwd_scratch_bytes", [ctypes.c_int] * 2,
                          ctypes.c_long)(R, D)
        scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
        s = _param(what, scale, x)
        launch(what, "layernorm", "clibd_layernorm_bwd",
               [rows.data_ptr(), dy.data_ptr(), s.data_ptr(),
                stats[0].data_ptr(), stats[1].data_ptr(), dx.data_ptr(), grads[0].data_ptr(),
                grads[1].data_ptr(), scratch.data_ptr()],
               [R, D, stride, DTYPE_CODE[x.dtype], int(fast)], x.device)
        layernorm_bwd.launches += 1
    return dx.reshape(x.shape), grads[0].to(scale.dtype), grads[1].to(scale.dtype)


# What the operator and its backward run on a CUDA tensor (module
# attributes, so that a measurement can send them to the plain versions on
# the card: `tools/profile_extract.plain_kernels`)
_cuda_fwd = layernorm_cuda
_cuda_bwd = layernorm_bwd_cuda


@torch.library.custom_op("clibd::layernorm", mutates_args=())
def _layernorm_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                  fast: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return layernorm_stats_reference(x, scale, bias, eps, fast)
    return _cuda_fwd(x, scale, bias, eps, fast)


@_layernorm_op.register_fake
def _(x, scale, bias, eps, fast):
    lead = x.shape[:-1]
    return (x.new_empty(x.shape), x.new_empty(lead, dtype=torch.float32),
            x.new_empty(lead, dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    x, scale, bias, eps, fast = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, scale, mean, rstd)
    ctx.mark_non_differentiable(mean, rstd)
    ctx.fast = fast
    ctx.bias_dtype = bias.dtype


def _backward(ctx, dy, _dmean, _drstd):
    x, scale, mean, rstd = ctx.saved_tensors
    dx, dscale, dbias = layernorm_bwd(x, dy, scale, mean, rstd, ctx.fast)
    return dx, dscale, dbias.to(ctx.bias_dtype), None, None


_layernorm_op.register_autograd(_backward, setup_context=_setup_context)


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor, fast: bool = False):
    """The backward alone: (dx, dscale, dbias) from x, dy and the forward's
    row statistics; the kernels on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return layernorm_bwd_reference(x, dy, scale, mean, rstd, fast)
    return _cuda_bwd(x, dy, scale, mean, rstd, fast)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-12, fast: bool = False) -> torch.Tensor:
    """LayerNorm of x [..., D] with scale and bias [D], differentiable in all
    three: the plain version on a CPU tensor, the operator (the kernels) on a
    CUDA tensor."""
    if x.device.type == "cpu":
        return layernorm_reference(x, scale, bias, eps, fast)
    return _layernorm_op(x, scale, bias, eps, fast)[0]


# launches of each kernel, counted where the wrapper launches it
layernorm.launches = 0
layernorm_bwd.launches = 0
