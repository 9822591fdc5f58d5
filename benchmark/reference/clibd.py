"""Plain float32 reference of the CLIBD tri-encoder and its train step.

The benchmark's yardstick for the `clibd` configurations: ViT-B/16 on
images, BarcodeBERT on DNA k-mer ids, BERT-small plus a projection on
taxonomy text, L2-normalised into one space, trained by the multi-positive
InfoNCE over every ordered pair of modalities with AdamW on a one-cycle
schedule.  Written from the published description (timm ViT, HF BERT,
CLIBD's loss_func.py) in plain torch operations, float32 throughout, with
TF32 off; it imports nothing of the program under test and computes
everything it needs from the benchmark's own inputs: the weights drawn from
the seed, the host batches, and the augmentation draws, which it makes
again from the seed, the epoch and the batch index.

Parameters are a flat dict under the layout the benchmark draws them in
(`param_shapes`): weights stored [in, out], the blocks of a tower stacked
[L, ...], q/k/v one fused [D, 3D] projection.

Departures from the published models, on purpose:
- GELU is the exact erf form everywhere; a bf16 program may use the tanh
  form (its gap is part of what `correct` allows).
- The DNA readout is CLIBD's checkpoint quirk, softmax over the decoder's
  outputs and then the mean over every position (`readout: softmax_mean`);
  the text is pooled by the mean over every position, padding included, as
  CLIBD's language encoder does.
- `matmul_precision="fp8"` rounds both operands of every matmul of the
  encoders to float8 e4m3 with a per-tensor scale (straight through in the
  backward): the control that a lower precision has to fail.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3fn

# the recipe's settings this reference implements, at the program config's
# paths; the train driver refuses a recipe that differs
SETTINGS = {"loss.bind_to": "", "loss.no_image_text_loss": False,
            "loss.fix_temperature": False, "loss.local_loss": False,
            "optim.optimizer": "adamw", "optim.lr_scheduler": "one_cycle",
            "optim.grad_clip_norm": 0.0, "accum_steps": 1, "disable_lora": True}


def no_tf32() -> None:
    """float32 matmuls in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

BLOCK_KEYS = ("qkv_w", "qkv_b", "out_w", "out_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
              "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def _block_shapes(prefix: str, L: int, D: int, F: int) -> Dict[str, tuple]:
    return {f"{prefix}.qkv_w": (L, D, 3 * D), f"{prefix}.qkv_b": (L, 3 * D),
            f"{prefix}.out_w": (L, D, D), f"{prefix}.out_b": (L, D),
            f"{prefix}.fc1_w": (L, D, F), f"{prefix}.fc1_b": (L, F),
            f"{prefix}.fc2_w": (L, F, D), f"{prefix}.fc2_b": (L, D),
            f"{prefix}.ln1_scale": (L, D), f"{prefix}.ln1_bias": (L, D),
            f"{prefix}.ln2_scale": (L, D), f"{prefix}.ln2_bias": (L, D)}


def _bert_shapes(prefix: str, t: dict) -> Dict[str, tuple]:
    D = t["hidden_size"]
    out = {f"{prefix}.embeddings.word": (t["vocab_size"], D),
           f"{prefix}.embeddings.position": (t["max_position_embeddings"], D),
           f"{prefix}.embeddings.token_type": (t["type_vocab_size"], D),
           f"{prefix}.embeddings.ln.scale": (D,), f"{prefix}.embeddings.ln.bias": (D,)}
    out.update(_block_shapes(f"{prefix}.blocks", t["num_layers"], D, t["intermediate_size"]))
    return out


def param_shapes(widths: dict) -> Dict[str, tuple]:
    """Name → shape of every parameter, in the benchmark's layout."""
    img, dna, txt = widths["image"], widths["dna"], widths["language"]
    out_dim = widths["output_dim"]
    D = img["hidden_size"]
    p = img["patch_size"]
    n_img = (img["image_size"] // p) ** 2 + 1
    shapes = {"logit_scale": (),
              "image_encoder.cls_token": (1, 1, D),
              "image_encoder.pos_embed": (1, n_img, D),
              "image_encoder.patch_embed.w": (p * p * 3, D),
              "image_encoder.patch_embed.b": (D,)}
    shapes.update(_block_shapes("image_encoder.blocks", img["num_layers"], D, img["mlp_dim"]))
    shapes.update({"image_encoder.norm.scale": (D,), "image_encoder.norm.bias": (D,),
                   "image_encoder.head.w": (D, out_dim), "image_encoder.head.b": (out_dim,)})
    shapes.update(_bert_shapes("dna_encoder", dna))
    Dd = dna["hidden_size"]
    shapes.update({"dna_encoder.mlm_head.transform.w": (Dd, Dd),
                   "dna_encoder.mlm_head.transform.b": (Dd,),
                   "dna_encoder.mlm_head.ln.scale": (Dd,), "dna_encoder.mlm_head.ln.bias": (Dd,),
                   "dna_encoder.mlm_head.decoder.w": (Dd, out_dim),
                   "dna_encoder.mlm_head.decoder.b": (out_dim,)})
    shapes.update(_bert_shapes("language_encoder", txt))
    shapes.update({"language_proj.w": (txt["hidden_size"], out_dim),
                   "language_proj.b": (out_dim,)})
    return shapes


def init_kind(name: str) -> str:
    """How a parameter is drawn: "logit" (log 1/0.07), "one" (LayerNorm
    scales), "zero" (biases, LayerNorm shifts, the CLS token) or "normal"
    (N(0, 0.02) clipped at two standard deviations: matrices, embeddings,
    position tables)."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "logit_scale":
        return "logit"
    if leaf in ("scale", "ln1_scale", "ln2_scale"):
        return "one"
    if leaf in ("b", "bias", "qkv_b", "out_b", "fc1_b", "fc2_b", "ln1_bias", "ln2_bias",
                "cls_token"):
        return "zero"
    return "normal"


# ---------------------------------------------------------------------------
# Matmuls at the stated precision
# ---------------------------------------------------------------------------


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its absolute
    maximum onto 448), back in float32; the gradient passes straight."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t + (q - t.detach())


class Matmul:
    """x @ w in float32, or with both operands rounded to float8 first."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"matmul precision {precision!r}: fp32 or fp8")
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def layernorm(x, scale, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def l2_normalize(x, eps: float = 1e-12):
    return x / torch.clamp(torch.sqrt((x * x).sum(dim=-1, keepdim=True)), min=eps)


def self_attention(mm, x, w_qkv, b_qkv, w_out, b_out, heads: int, key_mask=None):
    """Multi-head attention from the fused projection; key_mask [B, N]
    (1 attend, 0 not) or None."""
    B, N, D = x.shape
    hd = D // heads
    qkv = mm(x, w_qkv) + b_qkv
    q, k, v = (t.reshape(B, N, heads, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if key_mask is not None:
        scores = scores.masked_fill(key_mask[:, None, None, :] == 0, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    ctx = mm(probs, v).transpose(1, 2).reshape(B, N, D)
    return mm(ctx, w_out) + b_out


def blocks(mm, P: dict, prefix: str, x, heads: int, eps: float, pre_ln: bool, key_mask=None):
    """The stacked transformer blocks: pre-LN (ViT) or post-LN (BERT)."""
    g = {k: P[f"{prefix}.{k}"] for k in BLOCK_KEYS}
    for i in range(g["qkv_w"].shape[0]):
        def attn(h):
            return self_attention(mm, h, g["qkv_w"][i], g["qkv_b"][i], g["out_w"][i],
                                  g["out_b"][i], heads, key_mask)

        def mlp(h):
            return mm(gelu(mm(h, g["fc1_w"][i]) + g["fc1_b"][i]), g["fc2_w"][i]) + g["fc2_b"][i]

        ln1 = (g["ln1_scale"][i], g["ln1_bias"][i], eps)
        ln2 = (g["ln2_scale"][i], g["ln2_bias"][i], eps)
        if pre_ln:
            x = x + attn(layernorm(x, *ln1))
            x = x + mlp(layernorm(x, *ln2))
        else:
            x = layernorm(x + attn(x), *ln1)
            x = layernorm(x + mlp(x), *ln2)
    return x


def vit(mm, P, w: dict, images):
    """images [B, S, S, 3] in [0, 1] → [B, output_dim]: (h, w, c)-ordered
    patches, CLS, position table, pre-LN blocks, LN of the CLS row, head."""
    B, S, _, C = images.shape
    p = w["patch_size"]
    n = S // p
    patches = images.reshape(B, n, p, n, p, C).permute(0, 1, 3, 2, 4, 5).reshape(B, n * n,
                                                                                 p * p * C)
    x = mm(patches, P["image_encoder.patch_embed.w"]) + P["image_encoder.patch_embed.b"]
    cls = P["image_encoder.cls_token"].expand(B, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + P["image_encoder.pos_embed"]
    x = blocks(mm, P, "image_encoder.blocks", x, w["num_heads"], w["layernorm_eps"], True)
    cls_out = layernorm(x[:, 0], P["image_encoder.norm.scale"], P["image_encoder.norm.bias"],
                        w["layernorm_eps"])
    return mm(cls_out, P["image_encoder.head.w"]) + P["image_encoder.head.b"]


def bert(mm, P, prefix: str, w: dict, ids, key_mask=None):
    """Word + position + token type 0 embeddings, LayerNorm, post-LN blocks."""
    e = f"{prefix}.embeddings"
    N = ids.shape[1]
    x = P[f"{e}.word"][ids.long()] + P[f"{e}.position"][:N][None] + P[f"{e}.token_type"][0]
    x = layernorm(x, P[f"{e}.ln.scale"], P[f"{e}.ln.bias"], w["layernorm_eps"])
    return blocks(mm, P, f"{prefix}.blocks", x, w["num_heads"], w["layernorm_eps"], False,
                  key_mask)


def dna_features(mm, P, w: dict, dna):
    """BarcodeBERT with its MLM head; the readout over every position."""
    if isinstance(dna, dict):
        ids, mask = dna["input_ids"], dna.get("attention_mask")
    else:
        ids, mask = dna, None
    h = bert(mm, P, "dna_encoder", w, ids, mask)
    m = "dna_encoder.mlm_head"
    h = gelu(mm(h, P[f"{m}.transform.w"]) + P[f"{m}.transform.b"])
    h = layernorm(h, P[f"{m}.ln.scale"], P[f"{m}.ln.bias"], w["layernorm_eps"])
    logits = mm(h, P[f"{m}.decoder.w"]) + P[f"{m}.decoder.b"]
    if w["readout"] == "softmax_mean":
        return torch.softmax(logits, dim=-1).mean(dim=1)
    if w["readout"] == "mean":
        return logits.mean(dim=1)
    raise ValueError(f"DNA readout {w['readout']!r}")


def language_features(mm, P, w: dict, language):
    h = bert(mm, P, "language_encoder", w, language["input_ids"], language["attention_mask"])
    return mm(h.mean(dim=1), P["language_proj.w"]) + P["language_proj.b"]


def encode(P: dict, widths: dict, images=None, dna=None, language=None,
           precision: str = "fp32") -> dict:
    """Unit-norm features of the modalities given: {image, dna, language}."""
    mm = Matmul(precision)
    out = {}
    if images is not None:
        out["image"] = l2_normalize(vit(mm, P, widths["image"], images))
    if dna is not None:
        out["dna"] = l2_normalize(dna_features(mm, P, widths["dna"], dna))
    if language is not None:
        out["language"] = l2_normalize(language_features(mm, P, widths["language"], language))
    return out


# ---------------------------------------------------------------------------
# Augmentation: flips, then a rotation by three shears
# ---------------------------------------------------------------------------


def batch_generator_seed(seed: int, epoch: int, batch_idx: int, rank: Optional[int] = None) -> int:
    """The seed of a batch's augmentation generator, from (seed, epoch,
    batch index) by numpy's SeedSequence; a rank of several draws from
    (that seed, rank)."""
    out = int(np.random.SeedSequence([seed, epoch, batch_idx]).generate_state(1, np.uint64)[0])
    if rank is not None:
        out = int(np.random.SeedSequence([out, rank]).generate_state(1, np.uint64)[0])
    return out


def _shift_rows(img, k):
    """out[b, i, j] = img[b, i, j + k[b, i]], zero where that leaves the
    canvas."""
    B, H, W, _ = img.shape
    src = torch.arange(W, device=img.device)[None, None, :] + k[:, :, None]
    ok = (src >= 0) & (src < W)
    out = torch.gather(img, 2, src.clamp(0, W - 1)[..., None].expand(B, H, W, img.shape[-1]))
    return out * ok[..., None]


def _shift_cols(img, k):
    """out[b, i, j] = img[b, i + k[b, j], j], zero where that leaves the
    canvas."""
    B, H, W, _ = img.shape
    src = torch.arange(H, device=img.device)[None, :, None] + k[:, None, :]
    ok = (src >= 0) & (src < H)
    out = torch.gather(img, 1, src.clamp(0, H - 1)[..., None].expand(B, H, W, img.shape[-1]))
    return out * ok[..., None]


def augment(images: torch.Tensor, generator: torch.Generator, max_degrees: float = 45.0):
    """[B, H, W, C] float → horizontal flip (p=.5), vertical flip (p=.5),
    rotation by U(±max_degrees) about the centre, nearest, zero fill.

    The draws, in order from the generator: B uniforms for the horizontal
    flips, B for the vertical, B for the angles.  The rotation is Paeth's
    R(θ) = shear_x(-tan θ/2) · shear_y(sin θ) · shear_x(-tan θ/2), each
    shear an integer shift per row or column rounded to nearest, on a
    canvas widened by the largest shift of a horizontal shear."""
    B, H, W, C = images.shape
    dev = images.device
    do_h = torch.rand(B, generator=generator, device=dev) < 0.5
    do_v = torch.rand(B, generator=generator, device=dev) < 0.5
    angles = (torch.rand(B, generator=generator, device=dev) * 2.0 - 1.0) * max_degrees
    x = torch.where(do_h[:, None, None, None], images.flip(2), images)
    x = torch.where(do_v[:, None, None, None], x.flip(1), x)

    theta = torch.deg2rad(angles.float())
    alpha, beta = -torch.tan(theta / 2.0), torch.sin(theta)
    pad = int(math.ceil(math.tan(math.radians(max_degrees) / 2.0) * (H / 2.0))) + 1
    Wk = W + 2 * pad
    canvas = torch.zeros(B, H, Wk, C, dtype=x.dtype, device=dev)
    canvas[:, :, pad:pad + W] = x
    row = torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2.0
    col = torch.arange(Wk, dtype=torch.float32, device=dev) - pad - (W - 1) / 2.0
    kx = torch.round(-alpha[:, None] * row[None]).long()   # [B, H]
    ky = torch.round(-beta[:, None] * col[None]).long()    # [B, Wk]
    canvas = _shift_rows(canvas, kx)
    canvas = _shift_cols(canvas, ky)
    canvas = _shift_rows(canvas, kx)
    return canvas[:, :, pad:pad + W]


# ---------------------------------------------------------------------------
# Loss, schedule, AdamW
# ---------------------------------------------------------------------------

MODALITIES = ("image", "dna", "language")


def contrastive_loss(features: dict, labels: torch.Tensor, logit_scale) -> torch.Tensor:
    """Mean over every ordered pair (a, b) of modalities of CE(s·a·bᵀ, M)
    and CE(s·b·aᵀ, M), M[i, j] = (label_i == label_j) as soft targets:
    CE(Z, M) = mean_i(-sum_j M_ij log_softmax(Z_i)_j)."""
    present = [m for m in MODALITIES if features.get(m) is not None]
    target = (labels[:, None] == labels[None, :]).float()
    normed = {m: l2_normalize(features[m]) for m in present}
    terms = []
    for a in present:
        for b in present:
            if a == b:
                continue
            sim = logit_scale * torch.matmul(normed[a], normed[b].T)
            for z in (sim, sim.T):
                terms.append(-(target * torch.log_softmax(z, dim=-1)).sum(dim=-1).mean())
    return sum(terms) / len(terms)


def one_cycle(max_lr: float, total_steps: int, pct_start: float, div_factor: float,
              final_div_factor: float):
    """torch OneCycleLR (cosine, no momentum cycling) as a function of the
    0-based update count."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    end1 = float(pct_start * total_steps) - 1.0
    end2 = float(total_steps) - 1.0

    def cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    def lr(step: int) -> float:
        if step <= end1:
            return cos(initial, max_lr, min(max(step / max(end1, 1e-9), 0.0), 1.0))
        return cos(max_lr, final, min(max((step - end1) / max(end2 - end1, 1e-9), 0.0), 1.0))

    return lr


def adamw_update(P: dict, grads: dict, state: dict, lr: float, beta1: float, beta2: float,
                 eps: float, weight_decay: float) -> None:
    """One decoupled-weight-decay Adam update of every parameter in `grads`,
    in place: p ← p(1 − lr·wd); m, v the bias-corrected moments;
    p ← p − lr/(1 − β1^t) · m / (sqrt(v)/sqrt(1 − β2^t) + eps)."""
    state["t"] = t = state.get("t", 0) + 1
    bc1, bc2 = 1.0 - beta1 ** t, 1.0 - beta2 ** t
    with torch.no_grad():
        for name, g in grads.items():
            p = P[name]
            m = state.setdefault(("m", name), torch.zeros_like(p))
            v = state.setdefault(("v", name), torch.zeros_like(p))
            p.mul_(1.0 - lr * weight_decay)
            m.mul_(beta1).add_(g, alpha=1.0 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
            p.sub_(lr / bc1 * m / (torch.sqrt(v) / math.sqrt(bc2) + eps))


def _rows(batch, lo: int, hi: int):
    if isinstance(batch, dict):
        return {k: _rows(v, lo, hi) for k, v in batch.items()}
    return batch[lo:hi]


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of x, in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def loss_and_grads(P: dict, widths: dict, images, dna, language, labels, block_rows: int,
                   precision: str = "fp32", group=None):
    """The batch's loss and the gradient of every parameter, with the
    activations of `block_rows` rows at a time: the features of every block
    without a graph, the loss and its gradient in the features, then each
    block again with a graph and its backward against its rows of that
    gradient.  → (loss, {name: grad}, {modality: this rank's unit
    features [B, d]}).

    group: a process group whose ranks hold the rows of one global batch
    in rank order; the features are gathered, every rank computes the
    global loss, and the parameters' gradients of the ranks' rows are summed
    over the ranks, so every rank ends with the global batch's gradients."""
    import torch.distributed as dist

    B = labels.shape[0]
    spans = [(lo, min(lo + block_rows, B)) for lo in range(0, B, block_rows)]

    def run(params, lo, hi):
        return encode(params, widths, None if images is None else images[lo:hi],
                      None if dna is None else _rows(dna, lo, hi),
                      None if language is None else _rows(language, lo, hi), precision)

    with torch.no_grad():
        parts = [run(P, lo, hi) for lo, hi in spans]
    feats = {m: torch.cat([p[m] for p in parts]) for m in parts[0]}
    local = {m: f.clone() for m, f in feats.items()}
    del parts
    first = 0
    if group is not None:
        first = dist.get_rank(group) * B
        feats = {m: _gather_rows(f, group) for m, f in feats.items()}
        labels = _gather_rows(labels, group)
    feats = {m: f.requires_grad_() for m, f in feats.items()}
    scale = P["logit_scale"].detach().clone().requires_grad_()
    loss = contrastive_loss(feats, labels, torch.exp(scale))
    d = torch.autograd.grad(loss, list(feats.values()) + [scale])
    cot = {m: g[first:first + B] for m, g in zip(feats, d[:-1])}
    leaves = {n: t.detach().requires_grad_() for n, t in P.items() if n != "logit_scale"}
    names = list(leaves)
    grads = {n: torch.zeros_like(t) for n, t in leaves.items()}
    for lo, hi in spans:
        out = run(leaves, lo, hi)
        got = torch.autograd.grad([out[m] for m in out], [leaves[n] for n in names],
                                  grad_outputs=[cot[m][lo:hi] for m in out], allow_unused=True)
        for n, g in zip(names, got):
            if g is not None:
                grads[n] += g
    if group is not None:
        for g in grads.values():
            dist.all_reduce(g, group=group)
    grads["logit_scale"] = d[-1].detach()
    return loss.detach(), grads, local
