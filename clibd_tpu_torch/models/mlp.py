"""MLP feature encoder: the port of `clibd_tpu/models/mlp.py` (reference
bioscanclip/model/mlp.py), Linear-ReLU-Linear-ReLU-Linear over pre-extracted
image or DNA features, output in fp32.  Parameter names match the JAX pytree
(`fc1`, `fc2`, `fc3`, each `w` [in, out] and `b`)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Linear


class MLPEncoder(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 512, output_dim: int = 512):
        super().__init__()
        self.fc1 = Linear(input_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, hidden_dim)
        self.fc3 = Linear(hidden_dim, output_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """`init_mlp_encoder_params`: torch nn.Linear's default draws."""
        for fc in (self.fc1, self.fc2, self.fc3):
            fc.reset_parameters(generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        """x [B, input_dim] → [B, output_dim] fp32 (`mlp_encoder_apply`)."""
        h = torch.relu(self.fc1(x, compute_dtype))
        h = torch.relu(self.fc2(h, compute_dtype))
        return self.fc3(h, compute_dtype).float()
