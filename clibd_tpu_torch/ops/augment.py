"""On-device batch augmentations: the port of `clibd_tpu/ops/augment.py`
(`:21-143`), the tail of the reference's train transform
(util/dataset.py:185-195): RandomHorizontalFlip(p=.5) →
RandomVerticalFlip(p=.5) → RandomRotation(±45°, nearest, zero fill).

Each takes [B, H, W, C] images and an explicit `torch.Generator` on the
images' device for its random draws.  For the same flip decisions and the
same angles the result is bit-identical to the JAX functions': both only
move values (and fill zeros).  The draws themselves differ, as torch and
jax.random give different numbers for any seed.

The rotation keeps the JAX package's Paeth three-shear decomposition
R(θ) = shear_x(-tan θ/2) · shear_y(sin θ) · shear_x(-tan θ/2), each shear an
integer shift per row (or column) with nearest rounding per shear, on a
canvas widened by the largest transient overflow.  The TPU version runs
each shear as binary select-rolls because gathers were slow there
(`augment.py:39-45`); here the three shifts are composed into one source
index per output pixel and the card does a single gather.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def flip(images: torch.Tensor, do_h: torch.Tensor, do_v: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the images where do_h [B] is true, then vertical
    where do_v [B] is true."""
    images = torch.where(do_h[:, None, None, None], images.flip(2), images)
    return torch.where(do_v[:, None, None, None], images.flip(1), images)


def random_flips(generator: torch.Generator, images: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Horizontal then vertical random flips, independent per image."""
    B = images.shape[0]
    do_h = torch.rand(B, generator=generator, device=images.device) < p
    do_v = torch.rand(B, generator=generator, device=images.device) < p
    return flip(images, do_h, do_v)


def random_rotate(generator: Optional[torch.Generator], images: torch.Tensor,
                  max_degrees: float = 45.0,
                  angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image rotation by U(-max, max) degrees (or by `angles` [B]),
    nearest-neighbour sampling around the image centre, zero fill."""
    B, H, W, C = images.shape
    dev = images.device
    if angles is None:
        angles = (torch.rand(B, generator=generator, device=dev) * 2.0 - 1.0) * max_degrees
    theta = torch.deg2rad(angles.to(device=dev, dtype=torch.float32))
    alpha = -torch.tan(theta / 2.0)  # shear_x factor (passes 1 and 3)
    beta = torch.sin(theta)          # shear_y factor (pass 2)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0

    # static shift bounds from max_degrees, as the JAX version's
    tmax = math.tan(math.radians(max_degrees) / 2.0)
    px = int(math.ceil(tmax * (H / 2.0))) + 1   # max |x| shift per shear_x
    Wk = W + 2 * px                               # work canvas width

    iy = torch.arange(H, dtype=torch.float32, device=dev) - cy
    xk = torch.arange(Wk, dtype=torch.float32, device=dev) - px - cx
    # per-row shift of the shear_x passes and per-column shift of shear_y:
    # pass output [.., j, ..] reads its input at [.., j + k, ..]
    k1 = torch.round(-alpha[:, None] * iy[None]).long()   # [B, H]
    k2 = torch.round(-beta[:, None] * xk[None]).long()    # [B, Wk]

    # walk each output pixel (row i, column w) back through the three passes
    i = torch.arange(H, device=dev)[None, :, None]
    w = torch.arange(W, device=dev)[None, None, :]
    u = w + px + k1[:, :, None]                   # pass 3 reads canvas column u
    ok = (u >= 0) & (u < Wk)
    u = u.clamp(0, Wk - 1)
    r = i + torch.gather(k2, 1, u.reshape(B, -1)).reshape(B, H, W)   # pass 2 reads row r
    ok &= (r >= 0) & (r < H)
    r = r.clamp(0, H - 1)
    c = u + torch.gather(k1, 1, r.reshape(B, -1)).reshape(B, H, W) - px  # pass 1: image column
    ok &= (c >= 0) & (c < W)
    c = c.clamp(0, W - 1)
    src = (torch.arange(B, device=dev)[:, None, None] * H + r) * W + c
    out = images.reshape(B * H * W, C).index_select(0, src.reshape(-1)).reshape(B, H, W, C)
    return torch.where(ok[..., None], out, torch.zeros((), dtype=images.dtype, device=dev))


def train_augment(generator: torch.Generator, images: torch.Tensor,
                  max_degrees: float = 45.0) -> torch.Tensor:
    """Flips + rotation, in the reference's post-crop augmentation order."""
    return random_rotate(generator, random_flips(generator, images), max_degrees)
