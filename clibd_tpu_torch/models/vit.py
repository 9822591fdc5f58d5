"""ViT-B/16 image encoder: the port of `clibd_tpu/models/vit.py`.

Patch embedding as one matmul over (h, w, c)-ordered patches, CLS token,
learned position embedding, pre-LN blocks, final LayerNorm on the CLS row
only, then a linear head to `output_dim`.  Input is NHWC float.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ViTConfig
from .layers import LayerNorm, Linear, TransformerStack, trunc_normal_
from .lora import Lora


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] NHWC → [B, N, patch*patch*3], (h, w, c) order in a patch."""
    B, H, W, C = images.shape
    p = patch_size
    x = images.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig, output_dim: int = 768, lora_rank: int = 0):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.patch_embed = Linear(cfg.patch_size * cfg.patch_size * 3, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, D))
        self.blocks = TransformerStack(cfg.num_layers, D, cfg.mlp_dim)
        self.norm = LayerNorm(D)
        self.head = Linear(D, output_dim)
        self.lora = Lora(cfg.num_layers, D, lora_rank) if lora_rank > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """`init_vit_params`: trunc-normal patch embed and position embed,
        zero CLS token, torch-default head, LoRA A uniform / B zero."""
        with torch.no_grad():
            trunc_normal_(self.patch_embed.w, generator)
            self.patch_embed.b.zero_()
            self.cls_token.zero_()
            trunc_normal_(self.pos_embed, generator)
        self.blocks.reset_parameters(generator)
        self.head.reset_parameters(generator)
        if self.lora is not None:
            self.lora.reset_parameters(generator)

    def forward(self, images: torch.Tensor, compute_dtype=torch.bfloat16,
                fast_math: bool = True, remat=False) -> torch.Tensor:
        """images [B, H, W, 3] float (normalised) → [B, output_dim] fp32."""
        cfg = self.cfg
        B = images.shape[0]
        x = self.patch_embed(patchify(images, cfg.patch_size), compute_dtype)
        cls = self.cls_token.to(compute_dtype).expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(compute_dtype)
        x = self.blocks(x, num_heads=cfg.num_heads, pre_ln=True, ln_eps=cfg.layernorm_eps,
                        lora=self.lora, compute_dtype=compute_dtype, fast_math=fast_math,
                        remat=remat)
        fast = fast_math and compute_dtype != torch.float32
        # LN is per token: normalising only the CLS row equals timm's
        # norm-then-select
        cls_out = self.norm(x[:, 0], cfg.layernorm_eps, fast=fast)
        return self.head(cls_out, compute_dtype).float()
