"""LoRA adapters on the fused qkv: the port of `clibd_tpu/models/lora.py`.

Rank-r adapters on q and v, stacked per layer: a_* [L, D, r], b_* [L, r, D];
`with_k` adds a_k/b_k, the q/k/v variant of the CLIP vision tower
(`clip.py`, `add_lora_layer_to_open_clip`).  A is U(±1/sqrt(D)), B starts at
zero, so a fresh adapter leaves the backbone's output unchanged.  The deltas
are folded into the fused qkv inside `layers.fused_qkv_attention`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .layers import uniform_


class Lora(nn.Module):
    def __init__(self, num_layers: int, dim: int, rank: int, with_k: bool = False):
        super().__init__()
        for n in ("q", "v", "k") if with_k else ("q", "v"):
            self.register_parameter(f"a_{n}", nn.Parameter(torch.zeros(num_layers, dim, rank)))
            self.register_parameter(f"b_{n}", nn.Parameter(torch.zeros(num_layers, rank, dim)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("a_"):
                    uniform_(p, generator, 1.0 / math.sqrt(p.shape[1]))
                else:
                    p.zero_()

    def stacked(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())


def merge_lora_into_qkv(stacked: Dict[str, torch.Tensor],
                        lora: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold the adapters into the fused qkv weights (inference export):
    W_q += A_q B_q and W_v += A_v B_v on the q/v thirds of qkv_w, and
    W_k += A_k B_k when the q/k/v variant's adapters are present."""
    qkv_w = stacked["qkv_w"].clone()
    D = qkv_w.shape[1]
    qkv_w[:, :, :D] += torch.matmul(lora["a_q"], lora["b_q"])
    qkv_w[:, :, 2 * D:] += torch.matmul(lora["a_v"], lora["b_v"])
    if "a_k" in lora:
        qkv_w[:, :, D:2 * D] += torch.matmul(lora["a_k"], lora["b_k"])
    out = dict(stacked)
    out["qkv_w"] = qkv_w
    return out
