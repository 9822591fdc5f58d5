# A copy of clibd_tpu/data/transforms.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Image transforms with torch-parity semantics, implemented as numpy ops.

The reference's transform stacks (util/dataset.py:169-223):

- train: ToTensor → Resize(256, antialias) → RandomResizedCrop(224, antialias)
         → RandomHorizontalFlip → RandomVerticalFlip → RandomRotation(±45)
- eval:  ToTensor → Resize(256, antialias) → CenterCrop(224)
         (or TensorResizeLongEdge(224) when `transform_with_resize`)

Design: bilinear resize (with torch's antialias filter) is expressed as two
separable weight-matrix multiplications (out = W_h · img · W_wᵀ) — exact
torch `F.interpolate(mode='bilinear', antialias=True)` parity (validated in
tests against torch), matmul-shaped so the identical code path runs as numpy
on the host or as MXU matmuls on device.  The eval transform is the
accuracy-parity-critical one; flips/rotation are train-time stochastic and
run on-device (ops/augment.py).

Note the reference does NOT ImageNet-normalize for the timm-ViT path —
encoder inputs are [0,1] floats (dataset.py:185-195).
"""

from __future__ import annotations

import functools
import io
import math
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# torch-parity bilinear resize as separable matmuls
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def resize_weight_matrix(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """[out_size, in_size] row-stochastic weights for 1D bilinear resize with
    torch semantics: center-aligned mapping in = (out + 0.5)·scale − 0.5,
    triangle filter with support max(1, scale) when antialias and
    downscaling."""
    scale = in_size / out_size
    support = max(scale, 1.0) if (antialias and scale > 1.0) else 1.0
    out_coords = (np.arange(out_size) + 0.5) * scale - 0.5
    lo = np.floor(out_coords - support).astype(np.int64)
    width = int(math.ceil(2 * support)) + 2
    idx = lo[:, None] + np.arange(width)[None, :]
    dist = np.abs((idx - out_coords[:, None]) / (support if support > 1.0 else 1.0))
    weights = np.maximum(1.0 - dist, 0.0)
    # torch drops out-of-range taps and renormalizes over in-range ones
    in_range = (idx >= 0) & (idx < in_size)
    weights = np.where(in_range, weights, 0.0)
    idx_clip = np.clip(idx, 0, in_size - 1)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(w, (np.repeat(np.arange(out_size), width), idx_clip.ravel()), weights.ravel())
    norm = w.sum(axis=1, keepdims=True)
    return (w / norm).astype(np.float32)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int, antialias: bool = True) -> np.ndarray:
    """img: [H, W, C] float32 → [out_h, out_w, C]."""
    h, w, _ = img.shape
    wh = resize_weight_matrix(h, out_h, antialias)
    ww = resize_weight_matrix(w, out_w, antialias)
    tmp = np.einsum("oh,hwc->owc", wh, img, optimize=True)
    return np.einsum("pw,owc->opc", ww, tmp, optimize=True)


def resize_shorter_edge(img: np.ndarray, size: int, antialias: bool = True) -> np.ndarray:
    """torchvision Resize(size): shorter edge → size, aspect preserved.

    The long edge TRUNCATES like torchvision's _compute_resized_output_size
    (`int(size * long / short)`) — rounding would shift the whole sampling
    grid for ~half of all non-integer aspect ratios."""
    h, w, _ = img.shape
    if h <= w:
        out_h, out_w = size, max(1, int(size * w / h))
    else:
        out_h, out_w = max(1, int(size * h / w)), size
    return resize_bilinear(img, out_h, out_w, antialias)


def resize_long_edge(img: np.ndarray, size: int) -> np.ndarray:
    """Reference TensorResizeLongEdge (util/util.py:881-897): long edge → size
    (int truncation of the scaled short edge, bilinear WITHOUT antialias,
    matching F.interpolate default)."""
    h, w, _ = img.shape
    scale = size / max(h, w)
    out_h, out_w = int(h * scale), int(w * scale)
    return resize_bilinear(img, max(out_h, 1), max(out_w, 1), antialias=False)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision CenterCrop with zero-padding when the image is smaller."""
    h, w, c = img.shape
    if h < size or w < size:
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        img = np.pad(
            img,
            ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
        )
        h, w, _ = img.shape
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return img[top : top + size, left : left + size]


def pad_to_square(img: np.ndarray, size: int = 224, fill: float = 0.0) -> np.ndarray:
    """Reference PadTo224Tensor (util/util.py:899-921)."""
    h, w, c = img.shape
    pad_h, pad_w = size - h, size - w
    return np.pad(
        img,
        ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
        constant_values=fill,
    )


# ---------------------------------------------------------------------------
# RandomResizedCrop (torchvision param sampling semantics)
# ---------------------------------------------------------------------------


def sample_resized_crop_params(
    rng: np.random.Generator,
    h: int,
    w: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """(top, left, height, width) — torchvision RandomResizedCrop.get_params."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # fallback: center crop at clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    top = (h - ch) // 2
    left = (w - cw) // 2
    return top, left, ch, cw


def random_resized_crop(
    rng: np.random.Generator, img: np.ndarray, size: int = 224, antialias: bool = True
) -> np.ndarray:
    top, left, ch, cw = sample_resized_crop_params(rng, img.shape[0], img.shape[1])
    crop = img[top : top + ch, left : left + cw]
    return resize_bilinear(crop, size, size, antialias)


# ---------------------------------------------------------------------------
# Full host-side pipelines (JPEG bytes → fixed [size, size, 3] float32 [0,1])
# ---------------------------------------------------------------------------


def decode_jpeg(data: bytes) -> np.ndarray:
    """→ [H, W, 3] uint8 (PIL path; the native C++ decoder replaces this on
    the hot path when built)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def eval_transform(
    jpeg: bytes, size: int = 224, resize_to: int = 256, long_edge: bool = False
) -> np.ndarray:
    """ToTensor → Resize(256, antialias) → CenterCrop(224); or the
    `transform_with_resize` long-edge variant. Returns [size,size,3] f32 [0,1]."""
    img = decode_jpeg(jpeg).astype(np.float32) / 255.0
    if long_edge:
        img = resize_long_edge(img, size)
        # DELIBERATE deviation: the reference composes only ToTensor +
        # TensorResizeLongEdge (dataset.py:209-214), which yields ragged
        # shapes that torch's default_collate cannot batch for non-square
        # inputs (the shipped 256×256 HDF5 payloads hide this).  Padding with
        # the reference's own PadTo224Tensor (util/util.py:899-921 — defined
        # there but never composed) keeps the mode usable; it is a no-op on
        # square inputs, i.e. exact parity on the published datasets.
        return pad_to_square(img, size)
    img = resize_shorter_edge(img, resize_to)
    return center_crop(img, size)


def train_transform(
    rng: np.random.Generator, jpeg: bytes, size: int = 224, resize_to: int = 256
) -> np.ndarray:
    """ToTensor → Resize(256) → RandomResizedCrop(224); flips/rotation run
    on-device (ops/augment.py). Returns [size,size,3] f32 [0,1]."""
    img = decode_jpeg(jpeg).astype(np.float32) / 255.0
    img = resize_shorter_edge(img, resize_to)
    return random_resized_crop(rng, img, size)
