"""CLIP towers of the OpenCLIP / BioCLIP backbone (`backbone: open_clip`):
the port of `clibd_tpu/models/clip.py`.

Vision: a CLIP ViT -- patch embedding without bias, class embedding, learned
positions, ln_pre, pre-LN blocks, ln_post on the class row, a linear
projection.  Text: token embedding plus learned positions, CAUSAL pre-LN
blocks, ln_final, the projection of the EOT token's feature (the argmax of
the ids in each row).  Both run the shared `TransformerStack` with the
configured activation (exact GELU for LAION-trained OpenCLIP, QuickGELU for
OpenAI weights); the causal mask depends on the query, so the text tower's
attention takes the eager path and never the attention kernels.  The towers
take no remat argument, as in the reference.

Parameter names match the JAX pytree (`patch_embed.w`, `class_embedding`,
`pos_embed`, `ln_pre`, `blocks`, `ln_post`, `proj`; `token_embedding`,
`pos_embed`, `blocks`, `ln_final`, `text_projection`), so
`convert.params_from_jax` maps one onto the other.  LoRA on the vision tower
adapts q, k and v (`add_lora_layer_to_open_clip`), on the text tower q and v.
`clip_params_from_state_dict` turns an open_clip state dict into the JAX
package's numpy pytrees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from .layers import BLOCK_KEYS, LayerNorm, Linear, TransformerStack, trunc_normal_
from .lora import Lora
from .vit import patchify


@dataclass
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    embed_dim: int = 768
    layernorm_eps: float = 1e-5
    activation: str = "gelu"  # "quick_gelu" for OpenAI weights

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclass
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    embed_dim: int = 768
    layernorm_eps: float = 1e-5
    activation: str = "gelu"


CLIP_IMAGE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_normalize(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC floats → CLIP-normalised (the OpenCLIP eval transform's
    Normalize step); fp32 out for fp32 or bf16 in, as the reference promotes."""
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=images.device)
    std = torch.as_tensor(CLIP_IMAGE_STD, device=images.device)
    return (images - mean) / std


def causal_mask_bias(n: int, device=None) -> torch.Tensor:
    """[1, 1, N, N] additive bias: finfo(float32).min above the diagonal."""
    neg = torch.finfo(torch.float32).min
    return torch.triu(torch.full((n, n), neg, device=device), diagonal=1)[None, None]


class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, lora_rank: int = 0):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.patch_embed = Linear(cfg.patch_size * cfg.patch_size * 3, D, with_bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.seq_len, D))
        self.ln_pre = LayerNorm(D)
        self.blocks = TransformerStack(cfg.num_layers, D, cfg.mlp_dim)
        self.ln_post = LayerNorm(D)
        self.proj = nn.Parameter(torch.zeros(D, cfg.embed_dim))
        self.lora = Lora(cfg.num_layers, D, lora_rank, with_k=True) if lora_rank > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """`init_clip_vision_params`: trunc-normal 0.02 embeddings and
        projection, unit LayerNorms, LoRA A uniform / B zero."""
        with torch.no_grad():
            for p in (self.patch_embed.w, self.class_embedding, self.pos_embed, self.proj):
                trunc_normal_(p, generator)
            for ln in (self.ln_pre, self.ln_post):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
        self.blocks.reset_parameters(generator)
        if self.lora is not None:
            self.lora.reset_parameters(generator)

    def forward(self, images: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        """images [B, S, S, 3], CLIP-normalised → [B, embed_dim] fp32."""
        cfg = self.cfg
        B = images.shape[0]
        x = self.patch_embed(patchify(images, cfg.patch_size), compute_dtype)
        cls = self.class_embedding.to(compute_dtype).expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(compute_dtype)[None]
        x = self.ln_pre(x, cfg.layernorm_eps)
        x = self.blocks(x, num_heads=cfg.num_heads, pre_ln=True, ln_eps=cfg.layernorm_eps,
                        lora=self.lora, compute_dtype=compute_dtype, activation=cfg.activation)
        pooled = self.ln_post(x[:, 0], cfg.layernorm_eps)
        return torch.matmul(pooled.to(compute_dtype), self.proj.to(compute_dtype)).float()


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, lora_rank: int = 0):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, D))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.context_length, D))
        self.blocks = TransformerStack(cfg.num_layers, D, cfg.mlp_dim)
        self.ln_final = LayerNorm(D)
        self.text_projection = nn.Parameter(torch.zeros(D, cfg.embed_dim))
        self.lora = Lora(cfg.num_layers, D, lora_rank) if lora_rank > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """`init_clip_text_params`: trunc-normal 0.02 embeddings and
        projection, unit LayerNorm, LoRA A uniform / B zero."""
        with torch.no_grad():
            for p in (self.token_embedding, self.pos_embed, self.text_projection):
                trunc_normal_(p, generator)
            self.ln_final.scale.fill_(1.0)
            self.ln_final.bias.zero_()
        self.blocks.reset_parameters(generator)
        if self.lora is not None:
            self.lora.reset_parameters(generator)

    def forward(self, token_ids: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
        """token_ids [B, N] int (BPE, 0-padded, EOT the largest id of each
        row) → [B, embed_dim] fp32."""
        cfg = self.cfg
        B, N = token_ids.shape
        token_ids = token_ids.long()
        x = self.token_embedding[token_ids].to(compute_dtype)
        x = x + self.pos_embed[:N].to(compute_dtype)[None]
        x = self.blocks(x, num_heads=cfg.num_heads, pre_ln=True, ln_eps=cfg.layernorm_eps,
                        mask_bias=causal_mask_bias(N, x.device), lora=self.lora,
                        compute_dtype=compute_dtype, activation=cfg.activation)
        x = self.ln_final(x, cfg.layernorm_eps)
        pooled = x[torch.arange(B, device=x.device), token_ids.argmax(dim=-1)]
        return torch.matmul(pooled.to(compute_dtype),
                            self.text_projection.to(compute_dtype)).float()


def clip_params_from_state_dict(sd: Dict[str, np.ndarray], vcfg: CLIPVisionConfig,
                                tcfg: CLIPTextConfig) -> tuple:
    """open_clip state dict (visual.*, transformer.*, token_embedding, ...;
    numpy arrays or CPU tensors) → (vision pytree, text pytree, logit_scale)
    in the JAX package's layout: numpy, weights [in, out], per-layer blocks
    stacked, in_proj as the fused qkv."""
    def g(k):
        return np.asarray(sd[k])

    def blocks_from(prefix: str, num_layers: int) -> dict:
        names = {"qkv_w": "attn.in_proj_weight", "qkv_b": "attn.in_proj_bias",
                 "out_w": "attn.out_proj.weight", "out_b": "attn.out_proj.bias",
                 "fc1_w": "mlp.c_fc.weight", "fc1_b": "mlp.c_fc.bias",
                 "fc2_w": "mlp.c_proj.weight", "fc2_b": "mlp.c_proj.bias",
                 "ln1_scale": "ln_1.weight", "ln1_bias": "ln_1.bias",
                 "ln2_scale": "ln_2.weight", "ln2_bias": "ln_2.bias"}
        out = {}
        for key in BLOCK_KEYS:
            layers = [g(f"{prefix}.resblocks.{i}.{names[key]}") for i in range(num_layers)]
            out[key] = np.stack([a.T if key.endswith("_w") else a for a in layers])
        return out

    D = vcfg.hidden_size
    vision = {
        "patch_embed": {"w": g("visual.conv1.weight").transpose(2, 3, 1, 0).reshape(-1, D)},
        "class_embedding": g("visual.class_embedding"),
        "pos_embed": g("visual.positional_embedding"),
        "ln_pre": {"scale": g("visual.ln_pre.weight"), "bias": g("visual.ln_pre.bias")},
        "blocks": blocks_from("visual.transformer", vcfg.num_layers),
        "ln_post": {"scale": g("visual.ln_post.weight"), "bias": g("visual.ln_post.bias")},
        "proj": g("visual.proj"),
    }
    text = {
        "token_embedding": g("token_embedding.weight"),
        "pos_embed": g("positional_embedding"),
        "blocks": blocks_from("transformer", tcfg.num_layers),
        "ln_final": {"scale": g("ln_final.weight"), "bias": g("ln_final.bias")},
        "text_projection": g("text_projection"),
    }
    return vision, text, float(np.asarray(sd["logit_scale"]))
