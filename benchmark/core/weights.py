"""The weights of a run, drawn on the device from the seed.

One generator on the device, seeded from the run's seed, fills one flat
float32 buffer per kind of draw in a single call; the parameters are views
of it, in the layout the configuration's plain reference names
(`param_shapes`).  The same seed on the same device gives the same weights,
so the reference draws them again after the window rather than keeping a
copy beside the program's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

STD = 0.02


def draw_weights(shapes: Dict[str, tuple], init_kind, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """→ {name: float32 tensor on device}: "normal" N(0, 0.02) clipped at
    ±2 std, "zero", "one", "logit" log(1/0.07)."""
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    kinds = {n: init_kind(n) for n in shapes}
    numel = {n: math.prod(s) for n, s in shapes.items()}
    normal = [n for n in shapes if kinds[n] == "normal"]
    flat = torch.randn(sum(numel[n] for n in normal), generator=gen, device=device)
    flat.mul_(STD).clamp_(-2 * STD, 2 * STD)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for n in normal:
        out[n] = flat[at:at + numel[n]].view(shapes[n])
        at += numel[n]
    for n, kind in kinds.items():
        if kind == "zero":
            out[n] = torch.zeros(shapes[n], device=device)
        elif kind == "one":
            out[n] = torch.ones(shapes[n], device=device)
        elif kind == "logit":
            out[n] = torch.full(shapes[n], math.log(1.0 / 0.07), device=device)
    return {n: out[n] for n in shapes}
