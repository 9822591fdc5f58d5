"""Batched colour augmentations on the device: the port of
`clibd_tpu/ops/color.py` (`:26-149`), the SimCLR pipeline's ColorJitter /
RandomGrayscale / GaussianBlur (reference util/dataset.py:305-326
get_simclr_pipeline_transform: ColorJitter(0.8s, 0.8s, 0.8s, 0.2s) at
p=0.8, grayscale at p=0.2, a blur kernel of about size/10, sigma
U(0.1, 2)).

Every op takes [B, H, W, 3] float images in [0, 1], the layout of
`ops/augment.py`, and the random ones an explicit `torch.Generator` on the
images' device.  torchvision's semantics: brightness, contrast and
saturation blend towards 0, the mean gray and the grayscale image; hue
shifts the HSV hue channel; results are clamped to [0, 1].  The blur is a
depthwise convolution (`conv2d` with one kernel per image and channel).
For the same draws the results agree with the JAX functions' to float
rounding; the draws themselves differ, as torch and jax.random give
different numbers for any seed.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_GRAY_W = (0.299, 0.587, 0.114)


def _gray_w(images: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_GRAY_W, dtype=images.dtype, device=images.device)


def _blend(a, b, factor):
    return torch.clamp(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def adjust_brightness(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(images, torch.zeros_like(images), factor[:, None, None, None])


def adjust_contrast(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    gray_mean = (images * _gray_w(images)).sum(-1, keepdim=True).mean(dim=(1, 2), keepdim=True)
    return _blend(images, gray_mean, factor[:, None, None, None])


def rgb_to_grayscale(images: torch.Tensor) -> torch.Tensor:
    return (images * _gray_w(images)).sum(-1, keepdim=True).expand(images.shape)


def adjust_saturation(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return _blend(images, rgb_to_grayscale(images), factor[:, None, None, None])


def adjust_hue(images: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """delta [B] in [-0.5, 0.5] turns of the hue wheel (torchvision's
    convention), by an HSV round trip."""
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    s = torch.where(v > 0, c / torch.clamp(v, min=1e-12), torch.zeros_like(v))
    safe_c = torch.clamp(c, min=1e-12)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = torch.where(c > 0, h, torch.zeros_like(h))

    h = (h + delta[:, None, None]) % 1.0

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = (i.long() % 6)[..., None]

    def pick(*candidates):
        return torch.stack(candidates, dim=-1).gather(-1, sector)[..., 0]

    out = torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)],
                      dim=-1)
    return torch.clamp(out, 0.0, 1.0)


def _uniform(generator, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def random_color_jitter(generator: torch.Generator, images: torch.Tensor,
                        brightness: float = 0.8, contrast: float = 0.8, saturation: float = 0.8,
                        hue: float = 0.2, p: float = 0.8) -> torch.Tensor:
    """torchvision ColorJitter applied with probability p per image, in the
    fixed order brightness → contrast → saturation → hue (torchvision
    shuffles the order per call; the JAX package fixes it, and so does the
    port)."""
    B, dev = images.shape[0], images.device
    apply = torch.rand(B, generator=generator, device=dev) < p
    fb = _uniform(generator, B, max(0.0, 1 - brightness), 1 + brightness, dev)
    fc = _uniform(generator, B, max(0.0, 1 - contrast), 1 + contrast, dev)
    fs = _uniform(generator, B, max(0.0, 1 - saturation), 1 + saturation, dev)
    fh = _uniform(generator, B, -hue, hue, dev)
    out = adjust_hue(adjust_saturation(adjust_contrast(adjust_brightness(images, fb), fc), fs), fh)
    return torch.where(apply[:, None, None, None], out, images)


def random_grayscale(generator: torch.Generator, images: torch.Tensor,
                     p: float = 0.2) -> torch.Tensor:
    apply = torch.rand(images.shape[0], generator=generator, device=images.device) < p
    return torch.where(apply[:, None, None, None], rgb_to_grayscale(images), images)


def blur(images: torch.Tensor, sigma: torch.Tensor, kernel_size: int = 21) -> torch.Tensor:
    """Separable Gaussian blur with one sigma [B] per image, edge padding,
    as two depthwise convolutions (rows, then columns)."""
    B, H, W, C = images.shape
    half = kernel_size // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=images.device)
    k = torch.exp(-(x[None, :] ** 2) / (2.0 * sigma.float()[:, None] ** 2))
    k = (k / k.sum(dim=1, keepdim=True)).to(images.dtype)            # [B, K]
    k = k.repeat_interleave(C, dim=0)                                 # [B*C, K]
    planes = images.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    planes = F.conv2d(F.pad(planes, (0, 0, half, half), mode="replicate"),
                      k[:, None, :, None], groups=B * C)
    planes = F.conv2d(F.pad(planes, (half, half, 0, 0), mode="replicate"),
                      k[:, None, None, :], groups=B * C)
    return planes.reshape(B, C, H, W).permute(0, 2, 3, 1)


def gaussian_blur(generator: torch.Generator, images: torch.Tensor, kernel_size: int = 21,
                  sigma_range: Tuple[float, float] = (0.1, 2.0)) -> torch.Tensor:
    """Separable Gaussian blur with per-image sigma ~ U(sigma_range)."""
    sigma = _uniform(generator, images.shape[0], sigma_range[0], sigma_range[1], images.device)
    return blur(images, sigma, kernel_size)


def simclr_augment(generator: torch.Generator, images: torch.Tensor, size: int = 224,
                   jitter_strength: float = 1.0) -> torch.Tensor:
    """The device-side tail of the SimCLR view pipeline: the host supplies
    random-resized-crop'd [B, size, size, 3] images; this applies hflip →
    colour jitter → grayscale → blur, the reference's order."""
    B = images.shape[0]
    do_h = torch.rand(B, generator=generator, device=images.device) < 0.5
    images = torch.where(do_h[:, None, None, None], images.flip(2), images)
    s = jitter_strength
    images = random_color_jitter(generator, images, 0.8 * s, 0.8 * s, 0.8 * s, 0.2 * s, p=0.8)
    images = random_grayscale(generator, images, p=0.2)
    ksize = int(0.1 * size)
    if ksize % 2 == 0:
        ksize -= 1
    return gaussian_blur(generator, images, kernel_size=max(ksize, 3))
