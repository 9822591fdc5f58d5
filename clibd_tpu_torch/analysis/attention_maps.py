"""Attention-rollout representation visualization: the port of
`clibd_tpu/analysis/attention_maps.py` (reference scripts/result/
representation_visualization/{image,dna}_representation_visualization.py,
590 LoC).

The reference hooks torch attention-dropout modules to capture per-layer
attention probabilities; here a probe forward re-runs the stacked
transformer in plain torch on an explicit device, in fp32 (the package
turns TF32 off at import), and returns the probabilities [L, B, H, N, N].
No attention kernel is involved: the JAX package computes these
probabilities in XLA math outside its Pallas kernels, and the port's forward
kernel never materialises them.  The bodies are the port's encoders' (pre-LN
ViT, post-LN BERT with the key-mask bias, LoRA on q and v), with the exact
GELU and fp32 LayerNorm of `models/layers.py`.

Rollout (reference image_representation_visualization.py:22-63): per layer
fuse heads (max/mean/min), zero the lowest `discard_ratio` of entries
(never the CLS column), A ← (fused + I)/2 row-normalized, multiply across
layers, read the CLS row. Two reference quirks are deliberately fixed and
documented: (a) the discard step only zeroed batch row 0 (the reference
runs B=1) — vectorized per-batch here; (b) `a / a.sum(dim=-1)` without
keepdim column-normalizes under torch broadcasting at B=1 — row
normalization (the published rollout algorithm, Abnar & Zuidema 2020) is
used here.  The rollout, the overlays, the figure writers and
`top_orders_barcodes` are the JAX package's, as they are.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..models.layers import attention_mask_bias, gelu, layernorm, linear

# ---------------------------------------------------------------------------
# Probability probes
# ---------------------------------------------------------------------------

_PROBE_PREFIXES = ("patch_embed.", "cls_token", "pos_embed", "blocks.", "lora.", "embeddings.")


def encoder_tensors(encoder, device: torch.device | str = "cuda") -> Dict[str, torch.Tensor]:
    """A ViT or BERT tower's parameters that the probe reads, fp32 on
    `device`, under the port's module names ("blocks.qkv_w", "lora.a_q",
    "embeddings.word", ...).  encoder: the port's `ViT` / `Bert` module, or
    the tower's JAX-layout param pytree as `engine.checkpoint.
    load_params_any` gives it."""
    if isinstance(encoder, torch.nn.Module):
        flat = dict(encoder.named_parameters())
    else:
        from ..models.convert import params_from_jax

        flat = params_from_jax(encoder)
    return {k: v.detach().to(device=device, dtype=torch.float32) for k, v in flat.items()
            if k.startswith(_PROBE_PREFIXES)}


def _sub(tensors: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in tensors.items() if k.startswith(prefix)}


def _stack_attention_probs(stacked: Dict[str, torch.Tensor], x: torch.Tensor, num_heads: int,
                           pre_ln: bool, ln_eps: float, mask_bias=None,
                           lora: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Run the stacked transformer (fp32) collecting per-layer attention
    probabilities → probs [L, B, H, N, N] on x's device."""
    f32 = torch.float32
    B, N, D = x.shape
    hd = D // num_heads
    use_lora = bool(lora) and lora["a_q"].numel() > 0

    def heads(t):
        return t.reshape(B, N, num_heads, hd).transpose(1, 2)

    def attn(inp, p, lo):
        qkv = linear(inp, p["qkv_w"], p["qkv_b"], f32)
        q, k, v = qkv.split(D, dim=-1)
        if use_lora:
            q = q + torch.matmul(torch.matmul(inp, lo["a_q"]), lo["b_q"])
            v = v + torch.matmul(torch.matmul(inp, lo["a_v"]), lo["b_v"])
        scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(hd)
        if mask_bias is not None:
            scores = scores + mask_bias
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, heads(v)).transpose(1, 2).reshape(B, N, D)
        return linear(ctx, p["out_w"], p["out_b"], f32), probs

    def mlp(inp, p):
        mid = gelu(linear(inp, p["fc1_w"], p["fc1_b"], f32))
        return linear(mid, p["fc2_w"], p["fc2_b"], f32)

    h = x.to(f32)
    out = []
    for i in range(stacked["qkv_w"].shape[0]):
        p = {name: t[i] for name, t in stacked.items()}
        lo = {name: t[i] for name, t in lora.items()} if use_lora else None
        if pre_ln:
            a_out, probs = attn(layernorm(h, p["ln1_scale"], p["ln1_bias"], ln_eps), p, lo)
            h = h + a_out
            h = h + mlp(layernorm(h, p["ln2_scale"], p["ln2_bias"], ln_eps), p)
        else:
            a_out, probs = attn(h, p, lo)
            h = layernorm(h + a_out, p["ln1_scale"], p["ln1_bias"], ln_eps)
            h = layernorm(h + mlp(h, p), p["ln2_scale"], p["ln2_bias"], ln_eps)
        out.append(probs)
    return torch.stack(out)


@torch.no_grad()
def vit_attention_probs(encoder, images, cfg, device: torch.device | str = "cuda") -> np.ndarray:
    """images [B, S, S, 3] normalized → probs [L, B, H, N, N] (N = 1+patches),
    computed on `device`.  encoder: the port's `ViT` or its param pytree
    (`encoder_tensors`)."""
    from ..models.vit import patchify

    t = encoder_tensors(encoder, device)
    images = torch.as_tensor(np.asarray(images, np.float32)).to(device)
    B = images.shape[0]
    x = linear(patchify(images, cfg.patch_size), t["patch_embed.w"], t["patch_embed.b"],
               torch.float32)
    cls = t["cls_token"].expand(B, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + t["pos_embed"]
    probs = _stack_attention_probs(_sub(t, "blocks."), x, cfg.num_heads, pre_ln=True,
                                   ln_eps=cfg.layernorm_eps, lora=_sub(t, "lora."))
    return probs.cpu().numpy()


@torch.no_grad()
def bert_attention_probs(encoder, input_ids, attention_mask, cfg,
                         device: torch.device | str = "cuda") -> np.ndarray:
    """BarcodeBERT/BERT attention probs [L, B, H, N, N] (post-LN stack),
    computed on `device`; attention_mask [B, N] {0, 1} or None."""
    t = encoder_tensors(encoder, device)
    ids = torch.as_tensor(np.asarray(input_ids)).to(device=device, dtype=torch.long)
    N = ids.shape[1]
    x = t["embeddings.word"][ids]
    x = x + t["embeddings.position"][:N][None, :, :]
    x = x + t["embeddings.token_type"][0][None, None, :]
    x = layernorm(x, t["embeddings.ln.scale"], t["embeddings.ln.bias"], cfg.layernorm_eps)
    bias = None
    if attention_mask is not None:
        bias = attention_mask_bias(torch.as_tensor(np.asarray(attention_mask)).to(device))
    probs = _stack_attention_probs(_sub(t, "blocks."), x, cfg.num_heads, pre_ln=False,
                                   ln_eps=cfg.layernorm_eps, mask_bias=bias,
                                   lora=_sub(t, "lora."))
    return probs.cpu().numpy()


# ---------------------------------------------------------------------------
# Rollout
# ---------------------------------------------------------------------------


def attention_rollout(
    probs: np.ndarray,
    discard_ratio: float = 0.9,
    head_fusion: str = "max",
    layer_idx: Optional[int] = None,
    layer_range: tuple = (1, -6),
) -> np.ndarray:
    """probs [L, B, H, N, N] → CLS-to-token rollout mask [B, N-1], each row
    normalized to max 1. Default layer window = the reference's
    `attentions[1:-6]`; layer_idx selects a single layer instead."""
    L = probs.shape[0]
    if layer_idx is not None:
        layers = probs[layer_idx:layer_idx + 1]
    else:
        lo, hi = layer_range
        layers = probs[lo:hi if hi != 0 else L]
        if layers.shape[0] == 0:  # shallow probe models
            layers = probs
    B, _h, N, _ = layers.shape[1:]
    result = np.broadcast_to(np.eye(N, dtype=np.float64), (B, N, N)).copy()
    for attention in layers:
        if head_fusion == "mean":
            fused = attention.mean(axis=1)
        elif head_fusion == "max":
            fused = attention.max(axis=1)
        elif head_fusion == "min":
            fused = attention.min(axis=1)
        else:
            raise ValueError(f"head_fusion {head_fusion!r} not supported")
        fused = fused.astype(np.float64)
        flat = fused.reshape(B, -1)
        k = int(flat.shape[-1] * discard_ratio)
        if k > 0:
            idx = np.argpartition(flat, k, axis=-1)[:, :k]
            keep_cls = idx % N != 0  # never drop attention INTO the CLS column
            for b in range(B):
                cols = idx[b][keep_cls[b]]
                flat[b, cols] = 0.0
        a = (flat.reshape(B, N, N) + np.eye(N)) / 2.0
        a = a / a.sum(axis=-1, keepdims=True)
        result = a @ result
    mask = result[:, 0, 1:]
    mx = mask.max(axis=-1, keepdims=True)
    return (mask / np.maximum(mx, 1e-12)).astype(np.float32)


def mask_to_grid(mask_row: np.ndarray) -> np.ndarray:
    """[N-1] patch mask → [w, w] (224/16 → 14×14)."""
    width = int(round(len(mask_row) ** 0.5))
    return mask_row[: width * width].reshape(width, width)


def overlay_mask(image: np.ndarray, mask_grid: np.ndarray) -> np.ndarray:
    """Heatmap overlay (reference show_mask_on_image, :128-136): jet-colored
    upsampled mask blended onto the [H, W, 3] float image."""
    from matplotlib import cm

    from ..data.transforms import resize_bilinear

    H, W = image.shape[:2]
    up = resize_bilinear(mask_grid[..., None].astype(np.float32), H, W)[..., 0]
    heat = cm.jet(np.clip(up, 0, 1))[..., :3]
    out = heat * 0.5 + np.clip(image, 0, 1) * 0.5
    return np.clip(out / max(out.max(), 1e-12), 0, 1)


# ---------------------------------------------------------------------------
# Figures
# ---------------------------------------------------------------------------


def save_image_attention_figure(
    out_path: str,
    images: np.ndarray,
    masks_by_row: Dict[str, np.ndarray],
) -> str:
    """Grid figure: row 0 = original images, then one row per labeled mask
    set (e.g. "before alignment", "after alignment") — reference
    plot_figure(:167-206)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    rows = 1 + len(masks_by_row)
    fig, axes = plt.subplots(rows, n, figsize=(2 * n, 2 * rows), squeeze=False)
    for j in range(n):
        axes[0][j].imshow(np.clip(images[j], 0, 1))
        axes[0][j].axis("off")
    axes[0][0].set_ylabel("original")
    for i, (label, masks) in enumerate(masks_by_row.items(), start=1):
        for j in range(n):
            axes[i][j].imshow(overlay_mask(images[j], mask_to_grid(masks[j])))
            axes[i][j].axis("off")
        axes[i][0].set_title(label, fontsize=8, loc="left")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def save_dna_attention_figure(
    out_path: str,
    masks_by_order: Dict[str, np.ndarray],
) -> str:
    """Per-order token-importance heatmaps ([n_samples, n_tokens] each) —
    the DNA variant's output (dna_representation_visualization.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(masks_by_order)
    fig, axes = plt.subplots(n, 1, figsize=(10, 1.6 * n), squeeze=False)
    for i, (order, masks) in enumerate(masks_by_order.items()):
        ax = axes[i][0]
        ax.imshow(np.asarray(masks), aspect="auto", cmap="viridis",
                  interpolation="nearest")
        ax.set_ylabel(order, fontsize=8, rotation=0, ha="right", va="center")
        ax.set_yticks([])
        if i < n - 1:
            ax.set_xticks([])
    axes[-1][0].set_xlabel("token position")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def top_orders_barcodes(hdf5_path: str, split: str, n_orders: int = 5,
                        n_samples: int = 10):
    """→ {order: [barcode strings]} for the most frequent orders (reference
    get_top5_orders_dna_barcodes, dna_representation_visualization.py:124-153)."""
    from collections import Counter

    from ..data.hdf5 import BioscanSplit

    reader = BioscanSplit(hdf5_path, split)
    labels = reader.label_dicts()
    orders = [l["order"] for l in labels]
    top = [o for o, _c in Counter(orders).most_common(n_orders)]
    out: Dict[str, list] = {}
    for order in top:
        idx = np.asarray([i for i, o in enumerate(orders) if o == order][:n_samples])
        bs = reader.barcodes(idx)
        out[order] = [b.decode() if isinstance(b, bytes) else str(b) for b in bs]
    reader.close()
    return out
