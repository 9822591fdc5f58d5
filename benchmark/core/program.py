"""What the drivers share: the program's model with the benchmark's
weights, host batches sent up to the card, leaf norms, and freeing the
card after the window."""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np


def build_model(mc, weights: dict, device):
    """The program's model, its parameters the benchmark's weights."""
    import torch
    from clibd_tpu_torch.models.clibd import CLIBD, set_trainable

    with torch.device(device):
        model = CLIBD(mc)
    params = dict(model.named_parameters())
    if set(params) != set(weights) or any(params[n].shape != weights[n].shape for n in params):
        raise ValueError("the program's parameters are not the configuration's layout: "
                         f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
    return set_trainable(model, mc)


def to_device_batch(batch: dict, device):
    import torch

    def up(x):
        if isinstance(x, dict):
            return {k: up(v) for k, v in x.items()}
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return {k: up(v) for k, v in batch.items()}


def leaf_norms(tensors: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    import torch

    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].detach().double())
                         for n in names]).cpu().numpy()
    return dict(zip(names, norms.tolist()))


def free() -> None:
    """Give the card back what the dropped objects held."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
