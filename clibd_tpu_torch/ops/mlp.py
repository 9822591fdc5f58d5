"""The fused transformer MLP, act(x . W1 + b1) . W2 + b2 in one kernel: the
port of `clibd_tpu/ops/pallas/mlp.py::_mlp_kernel` and the custom VJP of
`_make_fused_mlp`.

`fused_mlp(x, w1, b1, w2, b2, activation)` takes x [..., D], w1 [D, F],
w2 [F, D] and returns [..., D] in x's dtype; activation is "gelu_tanh",
"gelu" (erf) or "quick_gelu".  It is one registered operator,
`clibd::fused_mlp`, so that selective activation checkpointing
(`models/layers.py`) sees one op: on a CUDA tensor it launches the
hand-written kernel (`csrc/fused_mlp.cu`), on a CPU tensor it runs the plain
version `fused_mlp_reference`.  There is no fallback from the card to the
plain version: a build or launch error raises.

The bf16 kernel reads every operand K-major (the wgmma layout), so the
wrapper hands it W1^T [F, D] and W2^T [D, F], transposed on every call:
4.7 MB each at D=768, microseconds against a kernel of milliseconds.  The
copies are not cached between calls: training updates the weights in place
(AdamW on BarcodeBERT with the knob on), and a cache keyed on the tensor
would hand the kernel stale weights.  fp32 inputs go to a SIMT kernel that
reads the weights as they are.

Numerics (`mlp.py:58-76`): h = x . W1 accumulated in fp32, plus the fp32
bias, the activation in fp32, h rounded to x's dtype; out = h . W2
accumulated in fp32 plus the fp32 bias, cast to x's dtype.  The backward is
autograd through the plain version, which recomputes the intermediate, as
the TPU package's VJP does (`mlp.py:120-125`).

Deliberately absent (TPU-only): `rows_block` / `f_block` and their
`CLIBD_MLP_ROWS_BLOCK` / `CLIBD_MLP_F_BLOCK` knobs, the host-side row
padding and the f_block divisor clamp (the kernel masks its ragged row tail
itself).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import DTYPE_CODE, function, launch

ACTIVATIONS = ("gelu_tanh", "gelu", "quick_gelu")


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu_tanh":
        return F.gelu(h, approximate="tanh")
    if activation == "gelu":
        return F.gelu(h)
    if activation == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    raise ValueError(f"activation {activation!r} is not one of {ACTIVATIONS}")


def fused_mlp_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, activation: str = "gelu_tanh") -> torch.Tensor:
    """Plain PyTorch version of the kernel: `_xla_mlp` (`mlp.py:72-76`).
    bf16 values are multiplied as fp32, which is exact, so each matmul here
    is a product accumulated in fp32."""
    h = torch.matmul(x.float(), w1.float())
    h = _act(h + b1.float(), activation).to(x.dtype)
    out = torch.matmul(h.float(), w2.float()) + b2.float()
    return out.to(x.dtype)


def fused_mlp_cuda(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, activation: str = "gelu_tanh") -> torch.Tensor:
    """Launch the kernel on x [R, D] → [R, D].  The biases go to the kernel
    as fp32, as the TPU kernel reads them."""
    what = "fused_mlp"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in DTYPE_CODE or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype}, w1 {w1.dtype}, w2 {w2.dtype} (one dtype, "
                        "bf16 or fp32)")
    if activation not in ACTIVATIONS:
        raise ValueError(f"{what}: activation {activation!r} is not one of {ACTIVATIONS}")
    if x.dim() != 2:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not [R, D]")
    R, D = x.shape
    Fd = w1.shape[-1]
    if w1.shape != (D, Fd) or w2.shape != (Fd, D) or b1.shape != (Fd,) or b2.shape != (D,):
        raise ValueError(f"{what}: w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} do not fit x [R, {D}]")
    code = DTYPE_CODE[x.dtype]
    if not function(what, "clibd_fused_mlp_supported", [ctypes.c_int] * 3)(D, Fd, code):
        raise ValueError(f"{what}: D={D}, F={Fd} in {x.dtype} is not taken by the kernel "
                         "(bf16: D in 256/512/768 and F a multiple of 64)")
    tensors = [t.contiguous() for t in (x, w1, w2)]
    if any(t.device != x.device or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: x, w1 and w2 must be 16-byte aligned on {x.device}")
    x, w1, w2 = tensors
    if x.dtype == torch.bfloat16:
        w1, w2 = w1.t().contiguous(), w2.t().contiguous()
    b1, b2 = (b.to(device=x.device, dtype=torch.float32).contiguous() for b in (b1, b2))
    # the bf16 kernel reads the biases two floats at a time
    b1, b2 = (b if b.data_ptr() % 8 == 0 else b.clone() for b in (b1, b2))
    out = torch.empty_like(x)
    launch(what, what, "clibd_fused_mlp",
           [x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr()], [R, D, Fd, ACTIVATIONS.index(activation), code], x.device)
    fused_mlp.launches += 1
    return out


# What the operator runs on a CUDA tensor (a module attribute, so that a
# measurement can send it to the plain version on the card)
_cuda_mlp = fused_mlp_cuda


@torch.library.custom_op("clibd::fused_mlp", mutates_args=())
def _mlp_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor, activation: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2, activation)
    return _cuda_mlp(x, w1, b1, w2, b2, activation)


@_mlp_op.register_fake
def _(x, w1, b1, w2, b2, activation):
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    *tensors, activation = inputs
    ctx.save_for_backward(*tensors)
    ctx.activation = activation


def _backward(ctx, grad):
    tensors = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in tensors if t.requires_grad]
    with torch.enable_grad():
        out = fused_mlp_reference(*tensors, ctx.activation)
        grads = iter(torch.autograd.grad(out, wanted, grad))
    return (*(next(grads) if t.requires_grad else None for t in tensors), None)


_mlp_op.register_autograd(_backward, setup_context=_setup_context)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, activation: str = "gelu_tanh") -> torch.Tensor:
    """act(x . w1 + b1) . w2 + b2 on x [..., D] with the [..., F]
    intermediate kept out of device memory; differentiable in every input."""
    lead, D = x.shape[:-1], x.shape[-1]
    return _mlp_op(x.reshape(-1, D), w1, b1, w2, b2, activation).reshape(*lead, D)


# launches of the kernel, counted where the wrapper launches it
fused_mlp.launches = 0
