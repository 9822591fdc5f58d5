"""The attention backward kernel against its floor at the flagship's training
shapes: the port of the repository's `tools/exp_bwd_floor.py`.

    python3 -m clibd_tpu_torch.tools.exp_bwd_floor table     # the analytic floor (no card)
    python3 -m clibd_tpu_torch.tools.exp_bwd_floor measure   # row 2 timed on the card

The backward (`ops/attention.flash_attention_qkv_bwd`, `csrc/flash_attention_qkv_bwd.cu`)
must at least read qkv [B, N, 3D] and dO [B, N, D] and write dqkv
[B, N, 3D], bf16: 14 B N D bytes a layer; and it does five products of
2 N^2 64 operations a head (S, dP, dV, dQ, dK): 10 B H N^2 64.  Its floor
is the larger of the bytes over the H100's 3.35 TB/s and the operations
over its 989 TFLOP/s (bf16).  The shapes: B=500, ViT N=197 and
BarcodeBERT N=133 (the measure leg masks its last 8 keys, whose 4 B N
bytes it adds), D=768, H=12, 12 layers a tower.

`table` prints the floor per layer and per step (12 layers).  `measure`
times the kernel alone with CUDA events (median of 20 after 3 warm-up
calls), inputs qkv ~ 0.3 N(0, 1) and dO ~ N(0, 1) in bf16 from
`np.random.default_rng(0)`, beside its floor and SDPA's backward on the
same inputs, and holds 16 rows of it against its plain version; it
prints the card's name and power limit.  The JAX script's ATTN_BWD_GROUP
head-phasing A/B is a Mosaic knob of the TPU kernel with no counterpart
here, and its measured text is the TPU's.
"""

from __future__ import annotations

import argparse

import numpy as np

B = 500
LAYERS = 12
SHAPES = (("vit", 197, 768, 12, False), ("bert", 133, 768, 12, True))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16, published
MASKED_KEYS = 8
BWD_REL_TOL = 2e-2          # max |kernel - plain| / max |plain|, as the kernel's own check


def floor(b: int, n: int, d: int, h: int, masked: bool = False) -> dict:
    """One layer's backward at (b, n, d, h): bytes, operations and the floor
    in ms, with what bounds it."""
    nbytes = 14 * b * n * d + (4 * b * n if masked else 0)
    ops = 10 * b * h * n * n * (d // h)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "floor_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations"}


def table() -> list:
    rows = []
    print(f"{'tower':6s} {'N':>4s} {'GB/layer':>9s} {'GFLOP/layer':>12s} {'bytes ms':>9s} "
          f"{'ops ms':>8s} {'floor ms':>9s} {'x12 layers':>11s}")
    for name, n, d, h, _ in SHAPES:
        f = floor(B, n, d, h)
        rows.append({"tower": name, "N": n, **f})
        print(f"{name:6s} {n:4d} {f['bytes'] / 1e9:9.3f} {f['ops'] / 1e9:12.1f} "
              f"{f['bytes_ms']:9.4f} {f['ops_ms']:8.4f} {f['floor_ms']:9.4f} "
              f"{f['floor_ms'] * LAYERS:11.3f}  ({f['bound_by']})")
    total = sum(r["floor_ms"] for r in rows) * LAYERS
    print(f"floor of both towers' backward, a step: {total:.3f} ms (H100: 3.35 TB/s, "
          f"989 TFLOP/s bf16)")
    return rows


def inputs(n: int, d: int, masked: bool, device):
    import torch

    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((B, n, 3 * d), dtype=np.float32) * 0.3)
    dout = torch.from_numpy(rng.standard_normal((B, n, d), dtype=np.float32))
    mask = None
    if masked:
        m = np.zeros((B, n), np.float32)
        m[:, -MASKED_KEYS:] = np.finfo(np.float32).min
        mask = torch.from_numpy(m).to(device)
    return qkv.to(device, torch.bfloat16), dout.to(device, torch.bfloat16), mask


def measure() -> list:
    """Row 2 alone at each shape: kernel ms, its floor, SDPA's backward."""
    import torch

    from ..ops.attention import flash_attention_qkv_bwd, flash_attention_qkv_bwd_reference
    from ..utils.profiling import cuda_ms, require_card
    from .exp_flash import sdpa

    card = require_card("exp_bwd_floor measure")
    rows = []
    for name, n, d, h, masked in SHAPES:
        qkv, dout, mask = inputs(n, d, masked, "cuda")
        head = (qkv[:16], dout[:16], None if mask is None else mask[:16])
        got = flash_attention_qkv_bwd(*head[:2], h, head[2]).float()
        want = flash_attention_qkv_bwd_reference(*head[:2], h, head[2]).float()
        rel = float((got - want).abs().max() / want.abs().max())
        if not torch.isfinite(got).all() or rel > BWD_REL_TOL:
            raise RuntimeError(f"exp_bwd_floor: the backward kernel at {name} disagrees with its "
                               f"plain version ({rel:.3e} > {BWD_REL_TOL})")
        ms = cuda_ms(lambda: flash_attention_qkv_bwd(qkv, dout, h, mask))
        leaf = qkv.detach().requires_grad_()
        lib_out = sdpa(leaf, h, mask)
        grad_out = dout.view(B, n, h, d // h).transpose(1, 2)
        sdpa_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaf, grad_out, retain_graph=True))
        f = floor(B, n, d, h, masked)
        rows.append({"tower": name, "N": n, "masked": masked, "ms": ms, "sdpa_bwd_ms": sdpa_ms,
                     "rel_err_16_rows": rel, **f})
        print(f"{name:4s} B={B} N={n} mask={masked}: kernel {ms:.4f} ms/layer "
              f"(x{LAYERS} = {ms * LAYERS:.2f} ms/step-tower), floor {f['floor_ms']:.4f} ms "
              f"({f['bound_by']}; {ms / f['floor_ms']:.2f}x), SDPA backward {sdpa_ms:.4f} ms "
              f"({ms / sdpa_ms:.2f}x); 16 rows against plain {rel:.2e}  [{card}]", flush=True)
        del qkv, dout, mask, leaf, lib_out
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="table", choices=("table", "measure"))
    args = ap.parse_args(argv)
    return measure() if args.mode == "measure" else table()


if __name__ == "__main__":
    main()
