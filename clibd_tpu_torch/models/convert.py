"""Weights for the port: the npz round-trip of `clibd_tpu/models/convert.py`
(`flatten_pytree` / `unflatten_pytree` / `load_params_npz`, :305-334) and the
bridge from the JAX param pytree to the port's modules.

The port's modules use the pytree's own names and layouts -- weights [in, out],
per-layer blocks stacked [L, ...], one fused qkv [D, 3D], the patch-embed
weight in (h, w, c) patch order -- so the bridge is a renaming of paths
("a/b/c" → "a.b.c") with no transposes; the same holds for the CLIP towers
of `backbone: open_clip` (`clip_vision/...`, `clip_text/...`).  The
importers of torch state dicts (timm, HF, released `best.pth`,
`convert.py:94-300`) are not ported yet; `models.clip.clip_params_from_state_dict`
turns an open_clip state dict into the pytree this bridge takes.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..config import ExperimentConfig
from .clibd import CLIBD, set_trainable


def flatten_pytree(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_pytree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_pytree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_params_npz(path: str) -> dict:
    with np.load(path) as data:
        return unflatten_pytree({k: data[k] for k in data.files})


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy leaves) → the port's state dict."""
    return {key.replace("/", "."): torch.from_numpy(np.array(v, dtype=np.float32))
            for key, v in flatten_pytree(tree).items()}


def model_from_jax(tree: dict, cfg: ExperimentConfig,
                   device: torch.device | str = "cuda") -> CLIBD:
    """Build the `CLIBD` module for `cfg` and load the pytree into it; every
    parameter must be present and of the same shape (strict).  The trainable
    parameters are set by `set_trainable`."""
    model = CLIBD(cfg)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return set_trainable(model, cfg).to(device)


def load_model_npz(path: str, cfg: ExperimentConfig, device: torch.device | str = "cuda") -> CLIBD:
    """npz params as the JAX package writes them (a file, or a checkpoint
    directory holding params.npz) → `CLIBD` on `device`."""
    if os.path.isdir(path):
        path = os.path.join(path, "params.npz")
    return model_from_jax(load_params_npz(path), cfg, device)
