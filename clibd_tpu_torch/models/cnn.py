"""DNACNN legacy baseline: the port of `clibd_tpu/models/cnn.py` (reference
bioscanclip/model/cnn.py:1-28), a conv tower over one-hot DNA [B, L, 4, C_in]:
three stages of conv (3x3, valid in L, padded by 1 across the 4 bases) →
ReLU → (3, 1) max-pool, then flatten → linear → tanh.  BatchNorm is left out
(the identity in inference mode at init) and dropout is off, as in the JAX
package.  The conv weights keep the JAX pytree's HWIO layout under `w`, so
`convert.params_from_jax` loads its pytree.  Plain `conv2d`: the JAX package
runs `lax.conv` outside any kernel.  Kept for capability parity; unused by
the main path."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, uniform_


class Conv(nn.Module):
    """Conv weights w [kh, kw, c_in, c_out] (HWIO) and bias b [c_out]."""

    def __init__(self, cin: int, cout: int, kh: int = 3, kw: int = 3):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(kh, kw, cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        kh, kw, cin, _ = self.w.shape
        bound = 1.0 / math.sqrt(cin * kh * kw)
        with torch.no_grad():
            uniform_(self.w, generator, bound)
            uniform_(self.b, generator, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x NCHW → NCHW; valid in H, padded by 1 in W (reference padding=(0, 1))."""
        return F.conv2d(x, self.w.permute(3, 2, 0, 1), self.b, padding=(0, 1))


class DNACNN(nn.Module):
    def __init__(self, in_feature: int = 1, dim: int = 2208, embedding_dim: int = 512):
        super().__init__()
        self.conv1 = Conv(in_feature, 64)
        self.conv2 = Conv(64, 32)
        self.conv3 = Conv(32, 16)
        self.lin1 = Linear(dim, embedding_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """`init_dnacnn_params`: U(±1/sqrt(fan_in)) convs, torch-default linear."""
        for m in (self.conv1, self.conv2, self.conv3, self.lin1):
            m.reset_parameters(generator)

    def forward(self, onehot: torch.Tensor) -> torch.Tensor:
        """onehot [B, L, 4, C_in] → [B, embedding_dim] (`dnacnn_apply`)."""
        x = onehot.float().permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.max_pool2d(torch.relu(conv(x)), kernel_size=(3, 1), stride=(3, 1))
        # flatten in the JAX package's NHWC order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.tanh(x @ self.lin1.w + self.lin1.b)


def one_hot_dna(tokens: torch.Tensor, num_classes: int = 4) -> torch.Tensor:
    """[B, L] base indices (0..3) → [B, L, 4, 1]; an index outside the
    classes gives a zero row, as `jax.nn.one_hot` does."""
    classes = torch.arange(num_classes, device=tokens.device)
    return (tokens[..., None] == classes).float()[..., None]
