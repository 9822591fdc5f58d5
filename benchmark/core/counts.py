"""Operations and bytes of the work a batch asks for, from the shapes of the
configuration and the key masks of the batch; frozen here, whatever
kernels the program runs them in.

- GEMMs count 2 operations a multiply-add, at the padded lengths the recipe
  feeds, and read each operand once and write the result once, in bf16
  (the loss's similarity products: float32).
- An attention call over B rows of N queries, width D = H·64, reads its
  fused q/k/v and writes its context, 8·B·N·D bytes in bf16, and does
  4·N·D·K operations, K the keys the rows attend summed over the rows
  (B·N unmasked); its backward reads q/k/v, the output's gradient and
  writes dq/dk/dv, 14·B·N·D bytes, and does 10·N·D·K operations.
- A call's least time is the larger of its operations over the peak rate
  of their type and its bytes over the memory's rate.

A train step (remat of the blocks recomputes their forward GEMMs once; the
attention's context is kept) runs each GEMM of a block 4 times (forward,
recompute, the input's and the weight's gradient), the patch embedding's
twice (its input needs no gradient), the other GEMMs 3 times, each
attention forward and backward once; the model's operations are 3 times
the forward's (recomputation not counted).  Embedding runs each forward
once.

A configuration of the open_clip backbone (`clip` widths) has the CLIP
towers in place of the ViT and the BERT text tower (`models/clip.py`):
- vision: N = (S/p)² + 1, D, F and L from `vision_*`; the patch GEMM has
  no bias (its bytes are the same), the head is `proj` [D, embed_dim] on
  the class row;
- text: N = `context_length`, D, F and L from `text_*`, the head
  `text_projection` [D, embed_dim] on the EOT row.  Its attention is
  causal, so the rows attend K = B·(N+1)/2 keys (query i sees i+1): 4·N·D·K
  = 4·D·B·N(N+1)/2 operations forward, 10·N·D·K backward.  The rows come
  from the ids; CLIP text has no key mask.
Remat is counted from the configuration as for the other towers, but
`models/clip.py`'s towers ignore `remat` today, so until the program
honours it `gemm_roofline` counts their block GEMMs 4 times where 3 run.
The text tower's causal attention runs on the eager path (matmuls and a
softmax), not the attention kernels, so its least time sits in the
attention counts while its device time falls in the GEMM and elementwise
groups of `core/trace.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _image(widths: dict):
    """The image tower's S, p, L, D, F and head width: the CLIP vision
    tower's under `clip`, else the ViT's."""
    c = widths.get("clip")
    if c:
        return (c["image_size"], c["patch_size"], c["vision_layers"], c["vision_hidden"],
                c["vision_mlp"], c["embed_dim"])
    w = widths["image"]
    return (w["image_size"], w["patch_size"], w["num_layers"], w["hidden_size"], w["mlp_dim"],
            widths["output_dim"])


def towers(widths: dict, batch: dict) -> List[dict]:
    """The transformer towers a batch drives: name, layers L, length N,
    width D, MLP width F, rows B, and keys: the keys each row attends,
    summed over the rows (B·N where nothing is masked)."""
    out = []
    clip = widths.get("clip")
    if "image" in batch:
        S, p, L, D, F, _ = _image(widths)
        B = batch["image"].shape[0]
        N = (S // p) ** 2 + 1
        out.append({"name": "image", "L": L, "N": N, "D": D, "F": F, "B": B, "keys": B * N})
    if "dna" in batch:
        w = widths["dna"]
        dna = batch["dna"]
        ids = dna["input_ids"] if isinstance(dna, dict) else dna
        B, N = ids.shape
        keys = int(dna["attention_mask"].sum()) if isinstance(dna, dict) else B * N
        out.append({"name": "dna", "L": w["num_layers"], "N": N, "D": w["hidden_size"],
                    "F": w["intermediate_size"], "B": B, "keys": keys})
    if "language" in batch and clip:
        B, N = batch["language"]["input_ids"].shape
        out.append({"name": "language", "L": clip["text_layers"], "N": N,
                    "D": clip["text_hidden"], "F": clip["text_mlp"], "B": B,
                    "keys": B * (N + 1) / 2})
    elif "language" in batch:
        w = widths["language"]
        mask = batch["language"]["attention_mask"]
        B, N = mask.shape
        out.append({"name": "language", "L": w["num_layers"], "N": N, "D": w["hidden_size"],
                    "F": w["intermediate_size"], "B": B, "keys": int(mask.sum())})
    return out


def gemms(widths: dict, batch: dict) -> List[dict]:
    """Every GEMM of one forward: M, K, N, dtype, where ("block", "patch",
    "head", "loss") and how many layers run it."""
    out = []
    for t in towers(widths, batch):
        M, D, F = t["B"] * t["N"], t["D"], t["F"]
        for k, n in ((D, 3 * D), (D, D), (D, F), (F, D)):
            out.append({"M": M, "K": k, "N": n, "dtype": "bf16", "where": "block",
                        "count": t["L"]})
    out_dim = widths["output_dim"]
    if "image" in batch:
        S, p, _, D, _, head = _image(widths)
        B = batch["image"].shape[0]
        out.append({"M": B * (S // p) ** 2, "K": p ** 2 * 3, "N": D,
                    "dtype": "bf16", "where": "patch", "count": 1})
        out.append({"M": B, "K": D, "N": head, "dtype": "bf16", "where": "head", "count": 1})
    if "dna" in batch:
        t = next(t for t in towers(widths, batch) if t["name"] == "dna")
        M, D = t["B"] * t["N"], t["D"]
        out.append({"M": M, "K": D, "N": D, "dtype": "bf16", "where": "head", "count": 1})
        out.append({"M": M, "K": D, "N": out_dim, "dtype": "bf16", "where": "head", "count": 1})
    if "language" in batch:
        clip = widths.get("clip")
        B = batch["language"]["input_ids"].shape[0]
        K, N = ((clip["text_hidden"], clip["embed_dim"]) if clip else
                (widths["language"]["hidden_size"], out_dim))
        out.append({"M": B, "K": K, "N": N, "dtype": "bf16", "where": "head", "count": 1})
    return out


def loss_gemms(widths: dict, batch: dict) -> List[dict]:
    """The similarity products of the loss: one [B, d] x [d, B] a ordered
    pair of modalities, float32."""
    present = towers(widths, batch)
    B = present[0]["B"]
    pairs = len(present) * (len(present) - 1)
    return [{"M": B, "K": widths["output_dim"], "N": B, "dtype": "fp32", "where": "loss",
             "count": pairs}]


def _bound(flops: float, nbytes: float, dtype: str, peaks: dict) -> float:
    return max(flops / peaks["flops"][dtype], nbytes / peaks["hbm_bytes_per_s"])


def _gemm_call(g: dict, peaks: dict):
    flops = 2.0 * g["M"] * g["K"] * g["N"]
    size = 2 if g["dtype"] == "bf16" else 4
    nbytes = float(g["M"] * g["K"] + g["K"] * g["N"] + g["M"] * g["N"]) * size
    return flops, _bound(flops, nbytes, g["dtype"], peaks)


def batch_counts(widths: dict, batch: dict, mode: str, remat: bool,
                 peaks: Optional[dict]) -> Dict[str, Dict[str, float]]:
    """One batch's totals, mode "train" (one step) or "embed" (one
    forward): {"model": {"flops"}, "gemm": {"flops", "bound_s", "calls"},
    "attn_fwd": {...}, "attn_bwd": {...}}; bound_s is None without peaks."""
    fwd_flops = 0.0
    gemm = {"flops": 0.0, "bound_s": 0.0, "calls": 0}
    todo = gemms(widths, batch) + (loss_gemms(widths, batch) if mode == "train" else [])
    for g in todo:
        flops, bound = _gemm_call(g, peaks) if peaks else (2.0 * g["M"] * g["K"] * g["N"], 0.0)
        if g["where"] != "loss" or mode == "train":
            fwd_flops += flops * g["count"]
        if mode == "embed":
            runs = 1
        elif g["where"] == "block":
            runs = 4 if remat else 3
        elif g["where"] == "patch":
            runs = 2
        else:
            runs = 3
        gemm["flops"] += flops * g["count"] * runs
        gemm["bound_s"] += bound * g["count"] * runs
        gemm["calls"] += g["count"] * runs
    attn = {k: {"flops": 0.0, "bytes": 0.0, "bound_s": 0.0, "calls": 0}
            for k in ("attn_fwd", "attn_bwd")}
    for t in towers(widths, batch):
        B, N, D, keys = t["B"], t["N"], t["D"], t["keys"]
        for key, nbytes, ops in (("attn_fwd", 8.0 * B * N * D, 4.0 * N * D * keys),
                                 ("attn_bwd", 14.0 * B * N * D, 10.0 * N * D * keys)):
            if key == "attn_bwd" and mode != "train":
                continue
            a = attn[key]
            a["flops"] += ops * t["L"]
            a["bytes"] += nbytes * t["L"]
            a["bound_s"] += (_bound(ops, nbytes, "bf16", peaks) if peaks else 0.0) * t["L"]
            a["calls"] += t["L"]
        fwd_flops += 4.0 * N * D * keys * t["L"]
    model = fwd_flops * (3.0 if mode == "train" else 1.0)
    out = {"model": {"flops": model}, "gemm": gemm, **attn}
    if not peaks:
        for v in out.values():
            if "bound_s" in v:
                v["bound_s"] = None
    return out


def add_counts(total: Optional[dict], more: dict) -> dict:
    if total is None:
        return {k: dict(v) for k, v in more.items()}
    for k, v in more.items():
        for f, x in v.items():
            total[k][f] = None if x is None or total[k][f] is None else total[k][f] + x
    return total
