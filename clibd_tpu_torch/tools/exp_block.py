"""Block-stack ablations at the ViT-B/16 shape on one card: the port of the
repository's `tools/exp_block.py`.

    python3 -m clibd_tpu_torch.tools.exp_block [variant ...] [--device cpu]

(default variants: base bnhd lnbf16 tanh best)

Each variant runs a whole 12-layer pre-LN transformer stack (B=256, N=197,
D=768, H=12, F=3072) in plain PyTorch, bf16, as the JAX script's variant
computes it: every product in bf16 (fp32 accumulation, bf16 out), the
softmax in fp32, LayerNorm in fp32 (`ln_f32`) or with its normalise and
scale in bf16 (`ln_bf16`: "lnbf16"), GELU exact or tanh ("tanh"), the
attention on [B, H, N, 64] views ("base") or on [B, N, H, 64] ones without
an explicit transpose ("bnhd"); "best" is bnhd + lnbf16 + tanh, and
"bnhd_lnbf16" and "bnhd_tanh" pair them.  Weights N(0, 0.02) from
`np.random.default_rng(0)` in the JAX script's order, x ~ N(0, 1) from
`default_rng(1)`.

A row: the stack's device ms (CUDA events, median of 10 after 3 warm-up
runs) and its output's max |variant - base| against the first variant's.
On the card it prints the card's name and power limit; `--device cpu` runs
it on the CPU, only when asked (untimed there: the ms column reads "not
measured").
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

B, L, N, D, H, FF = 256, 12, 197, 768, 12, 3072
HD = D // H
VARIANTS = ("base", "bnhd", "lnbf16", "tanh", "best")
BNHD = ("bnhd", "bnhd_lnbf16", "bnhd_tanh", "best")
TANH = ("tanh", "bnhd_tanh", "best")
LNBF16 = ("lnbf16", "bnhd_lnbf16", "best")


def make_params(device) -> dict:
    """The stacked block weights, drawn as the JAX script draws them."""
    rng = np.random.default_rng(0)

    def g(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 0.02).to(device)

    p = {"qkv_w": g(L, D, 3 * D), "qkv_b": g(L, 3 * D), "out_w": g(L, D, D), "out_b": g(L, D),
         "fc1_w": g(L, D, FF), "fc1_b": g(L, FF), "fc2_w": g(L, FF, D), "fc2_b": g(L, D)}
    for ln in ("ln1", "ln2"):
        p[f"{ln}_scale"] = torch.ones(L, D, device=device)
        p[f"{ln}_bias"] = torch.zeros(L, D, device=device)
    return p


def make_input(device) -> torch.Tensor:
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.standard_normal((B, N, D), dtype=np.float32)).to(device)


def ln_f32(scale, bias, x, eps=1e-6):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def ln_bf16(scale, bias, x, eps=1e-6):
    mean = x.float().mean(dim=-1, keepdim=True).to(x.dtype)
    xc = x - mean
    var = xc.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return xc * inv * scale.to(x.dtype) + bias.to(x.dtype)


def dense(x, w, b, cd):
    return torch.matmul(x, w.to(cd)) + b.to(cd)


def build(variant: str):
    """→ run(params, x): the stack's output [B, N, D] in bf16."""
    cd = torch.bfloat16
    scale = 1.0 / math.sqrt(HD)
    ln = ln_bf16 if variant in LNBF16 else ln_f32
    approximate = "tanh" if variant in TANH else "none"

    def attn(p, x):
        q, k, v = dense(x, p["qkv_w"], p["qkv_b"], cd).split(D, dim=-1)
        if variant in BNHD:
            q, k, v = (t.reshape(B, N, H, HD) for t in (q, k, v))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            pr = torch.softmax(s.float(), dim=-1).to(cd)
            ctx = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(B, N, D)
        else:
            q, k, v = (t.reshape(B, N, H, HD).transpose(1, 2) for t in (q, k, v))
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
            pr = torch.softmax(s.float(), dim=-1).to(cd)
            ctx = torch.einsum("bhqk,bhkd->bhqd", pr, v).transpose(1, 2).reshape(B, N, D)
        return dense(ctx, p["out_w"], p["out_b"], cd)

    def mlp(p, x):
        h = F.gelu(dense(x, p["fc1_w"], p["fc1_b"], cd), approximate=approximate)
        return dense(h, p["fc2_w"], p["fc2_b"], cd)

    @torch.inference_mode()
    def run(params, x):
        h = x.to(cd)
        for layer in range(L):
            p = {k: v[layer] for k, v in params.items()}
            h = h + attn(p, ln(p["ln1_scale"], p["ln1_bias"], h))
            h = h + mlp(p, ln(p["ln2_scale"], p["ln2_bias"], h))
        return h

    return run


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.profiling import cuda_ms, require_card

    card = require_card("exp_block", args.device)
    device = torch.device(args.device)
    params, x = make_params(device), make_input(device)
    rows, base_out = [], None
    for v in args.variants or VARIANTS:
        fn = build(v)
        out = fn(params, x)
        base_out = out if base_out is None else base_out
        err = float((out.float() - base_out.float()).abs().max())
        scale = float(base_out.float().abs().max())
        ms = cuda_ms(lambda: fn(params, x), warmup=3, iters=10) if card else None
        rows.append({"variant": v, "ms": ms, "max_abs_err_vs_base": err, "base_max_abs": scale})
        shown = f"{ms:7.2f} ms/stack" if ms is not None else "not measured"
        print(f"{v:14s}: {shown}   maxerr_vs_base={err:.4f} (of max|base| {scale:.3f})",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
