"""Fused-qkv attention schedules on one CUDA card: the port of the experiment
script `tools/exp_flash.py`.

    python -m clibd_tpu_torch.tools.exp_flash [parity|bwd_parity|time|bwd_time|fwd_group] [int ...]

The JAX script asks whether the flash-attention kernels of the fused qkv
tensor run faster in other schedules.  Its kernels are ported as three CUDA
kernels (`ops/attention.py`), each computing what its JAX variant does:

- `phased`: `flash_attention_qkv_phased`, the forward with every head of a
  group's q.k^T first, then the softmaxes, then P.V (`_phased_kernel`); on
  Hopper the warpgroups of a CTA issue their `wgmma` products in turns, so
  one's softmax runs while the next one's products are in flight;
- `batched`: `flash_attention_qkv_batched`, the forward with every head of
  a query tile in one CTA (`_batched_kernel`), its three warpgroups walking
  the heads free of each other;
- the phased backward: `flash_attention_qkv_bwd_phased`, the backward with
  Pb and dS kept on chip so S and dP are computed once
  (`_phased_bwd_kernel`).

`v0` is the production kernels' counterpart (`flash_attention_qkv` and
`flash_attention_qkv_bwd`).  The modes, at the shapes of the JAX script
(H=12, hd=64, bf16 fused qkv [B, N, 2304]; N=197 unmasked, the ViT-B/16
tower, and N=133 with the last 9 keys at finfo(float32).min, BarcodeBERT):

- parity: B=5, `phased` and `batched` against the plain forward
  (`flash_attention_qkv_reference`), max|err| and OK/FAIL at 2e-2;
- bwd_parity: B=5, the phased backward against `v0` and against the plain
  backward, max|err| per part (dq, dk, dv) over the part's max|plain|, at
  2e-2;
- time [block_b ...]: B=256, `v0`, `phased` (the largest head group that
  fits the card's shared memory), `batched` and SDPA on head-split views of
  qkv (`sdpa`, a yardstick only), ms/call and TF/s (4*B*H*N^2*hd);
- bwd_time [block_b ...]: B=256, `v0`, the phased backward and SDPA's
  backward, ms/call and TF/s (10*B*H*N^2*hd, the products the backward
  needs; the JAX script counts 11);
- fwd_group [g ...] (default 0 2 3 4 6): B=256, the phased forward with g
  heads per group (0: all), the counterpart of the JAX script's sweep of
  `CLIBD_ATTN_FWD_GROUP`, which itself stays unported.  A group the kernel
  does not take, or whose shared memory does not fit, is printed as a row
  saying so, decided by the wrapper's query before any launch (every group
  of 1, 2, 3, 4, 6, 8, 12 dividing H fits at N <= 256); g = -1 (the
  script's `CLIBD_ATTN_FWD_BPHASE` variant) has no counterpart.

The `block_b` arguments are accepted and printed as having no counterpart:
the kernels' grids run over batch elements and query tiles, not batch
blocks.  The JAX script's `parity` feeds fp32; here the same seeded values
(numpy `default_rng(0)`, standard normal) are rounded to bf16, since the
kernels take bf16 only.  Device times by CUDA events (`utils/profiling.cuda_ms`),
in place of the JAX script's 24-application `fori_loop`.  Needs a CUDA card
and raises without one; prints the card's name and power limit first.  Each
mode returns its rows as dicts.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import (
    flash_attention_qkv,
    flash_attention_qkv_batched,
    flash_attention_qkv_bwd,
    flash_attention_qkv_bwd_phased,
    flash_attention_qkv_bwd_reference,
    flash_attention_qkv_phased,
    flash_attention_qkv_reference,
    phased_heads,
    phased_smem_bytes,
    smem_limit,
)
from ..utils.profiling import card_line, cuda_ms

H, HD = 12, 64
SHAPES = ((197, False), (133, True))  # (N, last 9 keys masked)
PARITY_B, TIME_B = 5, 256
TOL = 2e-2
# the JAX script's default integers of each mode
DEFAULT_INTS = {"parity": [], "bwd_parity": [], "time": [2, 4, 8], "bwd_time": [2, 4],
                "fwd_group": [0, 2, 3, 4, 6]}


def sdpa(qkv: torch.Tensor, num_heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled dot-product attention on head-split views of qkv: the closest
    single PyTorch call, for timing only."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    q, k, v = (t.view(B, N, num_heads, HD).transpose(1, 2) for t in qkv.split(D, dim=-1))
    bias = None if mask is None else mask[:, None, None, :].to(qkv.dtype)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def draw(rng: np.random.Generator, B: int, N: int, masked: bool, device, dout: bool = False):
    """(qkv, mask, dO or None) as the JAX script draws them, rounded to bf16."""
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * HD)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, N, H * HD)).astype(np.float32)) if dout else None
    mask = None
    if masked:
        mask = torch.zeros(B, N)
        mask[:, N - 9:] = torch.finfo(torch.float32).min
        mask = mask.to(device)
    g = None if g is None else g.to(device, torch.bfloat16)
    return qkv.to(device, torch.bfloat16), mask, g


def _rel_parts(got: torch.Tensor, want: torch.Tensor) -> List[float]:
    """max|got - want| / max|want| for each of dq, dk, dv."""
    D = want.shape[-1] // 3
    return [float((got[..., i * D:(i + 1) * D].float() - want[..., i * D:(i + 1) * D].float())
                  .abs().max() / want[..., i * D:(i + 1) * D].float().abs().max()) for i in range(3)]


def parity(device="cuda", B: int = PARITY_B) -> List[dict]:
    rng = np.random.default_rng(0)
    rows = []
    for N, masked in SHAPES:
        qkv, mask, _ = draw(rng, B, N, masked, device)
        ref = flash_attention_qkv_reference(qkv, H, mask).float()
        for name, fn in VARIANTS.items():
            err = float((fn(qkv, H, mask).float() - ref).abs().max())
            ok = err < TOL
            print(f"parity N={N} masked={masked} {name}: max|err|={err:.2e}  "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
            rows.append({"mode": "parity", "N": N, "masked": masked, "name": name, "err": err,
                         "ok": ok})
    return rows


def bwd_parity(device="cuda", B: int = PARITY_B) -> List[dict]:
    rng = np.random.default_rng(0)
    rows = []
    for N, masked in SHAPES:
        qkv, mask, g = draw(rng, B, N, masked, device, dout=True)
        plain = flash_attention_qkv_bwd_reference(qkv, g, H, mask)
        v0 = flash_attention_qkv_bwd(qkv, g, H, mask)
        got = flash_attention_qkv_bwd_phased(qkv, g, H, mask)
        rel, rel_v0 = _rel_parts(got, plain), _rel_parts(got, v0)
        ok = max(rel + rel_v0) <= TOL
        print(f"bwd parity N={N} masked={masked} phased: max|err|/max|plain| dq {rel[0]:.2e} "
              f"dk {rel[1]:.2e} dv {rel[2]:.2e}; against v0 dq {rel_v0[0]:.2e} dk {rel_v0[1]:.2e} "
              f"dv {rel_v0[2]:.2e}  {'OK' if ok else 'FAIL'}", flush=True)
        rows.append({"mode": "bwd_parity", "N": N, "masked": masked, "name": "phased",
                     "rel_plain": rel, "rel_v0": rel_v0, "ok": ok})
    return rows


def _no_block_b(block_bs: List[int]) -> None:
    if block_bs:
        print(f"block_b {block_bs}: no counterpart (the grids run over batch elements and query "
              f"tiles); each variant is timed once", flush=True)


def _timed(mode: str, N: int, masked: bool, name: str, fn: Callable, flops: float,
           extra: Optional[dict] = None) -> dict:
    ms = cuda_ms(fn)
    print(f"{'bwd ' if mode == 'bwd_time' else ''}N={N} masked={masked} {name:8s}: {ms:7.3f} "
          f"ms/call  {flops / ms / 1e9:5.1f} TF/s", flush=True)
    return {"mode": mode, "N": N, "masked": masked, "name": name, "ms": ms,
            "tflops": flops / ms / 1e9, **(extra or {})}


def timing(block_bs: List[int], device="cuda", B: int = TIME_B) -> List[dict]:
    _no_block_b(block_bs)
    rng = np.random.default_rng(0)
    rows = []
    for N, masked in SHAPES:
        qkv, mask, _ = draw(rng, B, N, masked, device)
        flops = 4 * B * H * N * N * HD
        G = phased_heads(N, H, None, smem_limit(device))
        for name, fn in (("v0", flash_attention_qkv), *VARIANTS.items(), ("sdpa", sdpa)):
            rows.append(_timed("time", N, masked, name, lambda fn=fn: fn(qkv, H, mask), flops,
                               {"heads_per_phase": G} if name == "phased" else None))
    return rows


def bwd_timing(block_bs: List[int], device="cuda", B: int = TIME_B) -> List[dict]:
    _no_block_b(block_bs)
    rng = np.random.default_rng(0)
    rows = []
    D = H * HD
    for N, masked in SHAPES:
        qkv, mask, _ = draw(rng, B, N, masked, device)
        dout = qkv[..., :D].contiguous()  # dO from the input, as the JAX script derives it
        leaf = qkv.detach().requires_grad_()
        lib_out = sdpa(leaf, H, mask)
        lib_grad = dout.view(B, N, H, HD).transpose(1, 2)
        flops = 10 * B * H * N * N * HD
        for name, fn in (("v0", lambda: flash_attention_qkv_bwd(qkv, dout, H, mask)),
                         ("phased", lambda: flash_attention_qkv_bwd_phased(qkv, dout, H, mask)),
                         ("sdpa", lambda: torch.autograd.grad(lib_out, leaf, lib_grad,
                                                              retain_graph=True))):
            rows.append(_timed("bwd_time", N, masked, name, fn, flops))
    return rows


def fwd_group(groups: List[int], device="cuda", B: int = TIME_B) -> List[dict]:
    rng = np.random.default_rng(0)
    limit = smem_limit(device)
    rows = []
    for N, masked in SHAPES:
        qkv, mask, _ = draw(rng, B, N, masked, device)
        flops = 4 * B * H * N * N * HD
        for g in groups:
            row = {"mode": "fwd_group", "N": N, "masked": masked, "name": f"fwd_group={g}",
                   "group": g}
            if g < 0:
                print(f"N={N} masked={masked} fwd_group={g:2d}: no counterpart (the block_b loop "
                      f"it flattens into the phases does not exist here)", flush=True)
                rows.append({**row, "fits": False})
                continue
            need = phased_smem_bytes(N, H, g or H)
            if not 0 < need <= limit:
                why = (f"does not fit: {need} bytes of shared memory, the card gives {limit}"
                       if need else "not a head group the kernel takes")
                print(f"N={N} masked={masked} fwd_group={g:2d}: {why}", flush=True)
                rows.append({**row, "fits": False, "smem": need, "limit": limit})
                continue
            rows.append({**_timed("fwd_group", N, masked, f"fwd_group={g:2d}",
                                  lambda g=g: flash_attention_qkv_phased(qkv, H, mask, g), flops),
                         "group": g, "fits": True, "smem": need, "limit": limit})
    return rows


VARIANTS: Dict[str, Callable] = {"phased": flash_attention_qkv_phased,
                                 "batched": flash_attention_qkv_batched}
# mode → its function of (the mode's integers)
MODES: Dict[str, Callable[[List[int]], List[dict]]] = {
    "parity": lambda ints: parity(),
    "bwd_parity": lambda ints: bwd_parity(),
    "time": timing,
    "bwd_time": bwd_timing,
    "fwd_group": fwd_group,
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="parity", choices=list(MODES))
    ap.add_argument("ints", nargs="*", type=int,
                    help="block_b values (time, bwd_time) or head groups (fwd_group)")
    args = ap.parse_args(argv)
    args.ints = args.ints or DEFAULT_INTS[args.mode]
    return args


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_flash needs a CUDA card")
    print(card_line(), flush=True)
    return MODES[args.mode](args.ints)


if __name__ == "__main__":
    main()
