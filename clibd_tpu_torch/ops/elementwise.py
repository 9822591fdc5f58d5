"""The scale copy y = alpha * x in fp32: the port of the bandwidth probe's
Pallas kernel, `tools/exp_attn.py::probe_pallas_bandwidth` (`kern`, o = i *
2.0 on fp32 [8192, 2048]).

`scale_copy(x, alpha=2.0)` returns a new fp32 tensor of x's shape.  On a
CUDA tensor it launches the hand-written kernel (`csrc/scale_copy.cu`: a
persistent grid, one contiguous range of 16-byte vectors a CTA, moved in
16 KB chunks by Hopper's 1-D bulk copies through a ring of 8 slots in
shared memory and multiplied there in place; a scalar tail); on a CPU
tensor it runs the plain version, `scale_copy_reference`.  An fp32 product
rounds once, so the two agree bit for bit.  There is no fallback from the
card to the plain version: a build or launch error raises.

Deliberately absent (TPU-only): the probe's [128, 2048] VMEM blocks and its
grid of 64; the ring's 16 KB slots are their counterpart.
"""

from __future__ import annotations

import torch

from .cuda_build import launch


def scale_copy_reference(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x * alpha."""
    return x * alpha


def scale_copy_cuda(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """Launch the kernel on a contiguous fp32 x → x * alpha."""
    what = "scale_copy"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: dtype {x.dtype} (fp32 only, as the TPU probe)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{what}: {x.numel()} elements (fewer than 2^31 only)")
    out = torch.empty_like(x)
    launch(what, what, "clibd_scale_copy", [x.data_ptr(), out.data_ptr()], [x.numel()],
           x.device, floats=[alpha])
    scale_copy.launches += 1
    return out


def scale_copy(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """x * alpha in fp32: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return scale_copy_reference(x, alpha)
    return scale_copy_cuda(x, alpha)


# launches of the kernel, counted where the wrapper launches it
scale_copy.launches = 0
