"""BarcodeBERT-shaped ablations on one card: the port of the repository's
`tools/exp_bert.py`.

    python3 -m clibd_tpu_torch.tools.exp_bert [variant ...] [--device cpu]

(default variants: base base_nohead fast fast_nohead)

Each variant runs a 12-layer post-LN BERT stack (B=256, N=133, D=768,
H=12, F=3072) in plain PyTorch, bf16, as the JAX script's variant computes
it: every product in bf16 (fp32 accumulation, bf16 out), the key-mask bias
added in bf16, the softmax in fp32; "base" with fp32 LayerNorm and exact
GELU, "fast" with LayerNorm's normalise and scale in bf16 and the tanh
GELU; with the 1030-way token head (softmax in fp32, averaged over the
tokens: [B, 1030]) or without it ("_nohead": the stack's output).  Weights
N(0, 0.02) from `np.random.default_rng(0)` in the JAX script's order,
x ~ N(0, 1) from `default_rng(1)`, every key kept.

A row: the device ms (CUDA events, median of 10 after 3 warm-up runs) and
the output's max |variant - base| against the base variant of its kind
(with or without the head) when that ran.  On the card it prints the
card's name and power limit; `--device cpu` runs it on the CPU, only when
asked (untimed there).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

B, L, N, D, H, FF, V = 256, 12, 133, 768, 12, 3072, 1030
HD = D // H
VARIANTS = ("base", "base_nohead", "fast", "fast_nohead")


def make_params(device) -> dict:
    rng = np.random.default_rng(0)

    def g(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.02).to(device)

    p = {"qkv_w": g(L, D, 3 * D), "qkv_b": g(L, 3 * D), "out_w": g(L, D, D), "out_b": g(L, D),
         "fc1_w": g(L, D, FF), "fc1_b": g(L, FF), "fc2_w": g(L, FF, D), "fc2_b": g(L, D)}
    for ln in ("ln1", "ln2"):
        p[f"{ln}_scale"] = torch.ones(L, D, device=device)
        p[f"{ln}_bias"] = torch.zeros(L, D, device=device)
    p["head_w"], p["head_b"] = g(D, V), g(V)
    return p


def make_inputs(device) -> tuple:
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, N, D), dtype=np.float32)).to(device)
    return x, torch.ones(B, N, dtype=torch.int32, device=device)


def dense(x, w, b, cd):
    return torch.matmul(x, w.to(cd)) + b.to(cd)


def build(variant: str):
    """→ run(params, x, mask): [B, V] fp32 with the head, else [B, N, D] bf16."""
    cd = torch.bfloat16
    scale = 1.0 / math.sqrt(HD)
    fast = variant.startswith("fast")
    with_head = not variant.endswith("_nohead")

    def ln(s, b, x, eps=1e-12):
        if fast:
            mean = x.float().mean(dim=-1, keepdim=True).to(x.dtype)
            xc = x - mean
            var = xc.float().square().mean(dim=-1, keepdim=True)
            return xc * torch.rsqrt(var + eps).to(x.dtype) * s.to(x.dtype) + b.to(x.dtype)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + eps) * s + b).to(x.dtype)

    def attn(p, x, bias):
        q, k, v = (t.reshape(B, N, H, HD).transpose(1, 2)
                   for t in dense(x, p["qkv_w"], p["qkv_b"], cd).split(D, dim=-1))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + bias.to(cd)
        pr = torch.softmax(s.float(), dim=-1).to(cd)
        ctx = torch.einsum("bhqk,bhkd->bhqd", pr, v).transpose(1, 2).reshape(B, N, D)
        return dense(ctx, p["out_w"], p["out_b"], cd)

    def mlp(p, x):
        h = F.gelu(dense(x, p["fc1_w"], p["fc1_b"], cd), approximate="tanh" if fast else "none")
        return dense(h, p["fc2_w"], p["fc2_b"], cd)

    @torch.inference_mode()
    def run(params, x, mask):
        bias = ((1.0 - mask.float()) * torch.finfo(torch.float32).min)[:, None, None, :]
        h = x.to(cd)
        for layer in range(L):
            p = {k: v[layer] for k, v in params.items() if k not in ("head_w", "head_b")}
            h = ln(p["ln1_scale"], p["ln1_bias"], h + attn(p, h, bias))
            h = ln(p["ln2_scale"], p["ln2_bias"], h + mlp(p, h))
        if with_head:
            logits = dense(h, params["head_w"], params["head_b"], cd)
            return torch.softmax(logits.float(), dim=-1).mean(dim=1)
        return h

    return run


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.profiling import cuda_ms, require_card

    card = require_card("exp_bert", args.device)
    device = torch.device(args.device)
    params, (x, mask) = make_params(device), make_inputs(device)
    rows, bases = [], {}
    for v in args.variants or VARIANTS:
        fn = build(v)
        out = fn(params, x, mask)
        kind = v.endswith("_nohead")
        if v.startswith("base"):
            bases[kind] = out
        ref = bases.get(kind)
        err = None if ref is None else float((out.float() - ref.float()).abs().max())
        scale = None if ref is None else float(ref.float().abs().max())
        ms = cuda_ms(lambda: fn(params, x, mask), warmup=3, iters=10) if card else None
        rows.append({"variant": v, "ms": ms, "max_abs_err_vs_base": err, "base_max_abs": scale})
        shown = f"{ms:7.2f} ms" if ms is not None else "not measured"
        vs = "" if err is None else f"   maxerr_vs_base={err:.3e} (of max|base| {scale:.3e})"
        print(f"{v:14s}: {shown}{vs}", flush=True)
    return rows


if __name__ == "__main__":
    main()
