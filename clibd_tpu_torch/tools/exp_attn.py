"""Chip probes and attention variants on one CUDA card: the port of the
experiment script `tools/exp_attn.py`.

    python -m clibd_tpu_torch.tools.exp_attn [all|probe|xla|dpa|pallas|extra]

Measures (1) whether a hand-written kernel streams at the card's memory rate
(the scale copy, `ops/elementwise.scale_copy`, on fp32 [8192, 2048]) and
reaches its tensor cores (the tiled GEMM, `ops/gemm.tiled_matmul`, at
1024^3), and (2) the per-layer cost of attention variants at ViT-B/16
shapes (B=256, H=12, N=197, hd=64, bf16):

- probe: the copy (ms, GB/s) and the 1024^3 GEMM (us, TFLOP/s);
- xla: the JAX script's two XLA attentions as plain torch ops with the same
  dtypes (`attn_xla_current`: bf16 scores, fp32 softmax, bf16 P.V;
  `attn_xla_bf16softmax`: fp32 scores, bf16 exponentials);
- dpa: `F.scaled_dot_product_attention`, the counterpart of
  `jax.nn.dot_product_attention`;
- pallas: the attention kernel from separate q, k, v
  (`ops/attention.attention_bhnd`, the port of `make_pallas_attn`), with
  maxerr against `attn_xla_current`, as the JAX script prints it;
- extra (not part of all): matmuls without softmax, a bf16 softmax, the
  softmax alone, and a 256 MB elementwise pass.

`all` runs probe, xla, dpa and pallas.  The plain variants are XLA
computations outside any Pallas kernel in the JAX script, so they stay torch
ops.  Times are device times by CUDA events (`utils/profiling.cuda_ms`,
median after warm-up runs); inputs are seeded with numpy as in the JAX
script.  Needs a CUDA card and raises without one; prints the card's name
and power limit first.  `make_pallas_attn`'s batch block `bb` (4 and 8 in
the JAX script) has no counterpart: a CTA of the kernel walks a group of
(batch, head) slabs for 64 query rows, the group picked per launch.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import attention_bhnd
from ..ops.elementwise import scale_copy
from ..ops.gemm import tiled_matmul
from ..utils.profiling import card_line, cuda_ms

MODES = ("all", "probe", "xla", "dpa", "pallas", "extra")
B, H, N, HD = 256, 12, 197, 64
COPY_SHAPE = (8192, 2048)  # fp32, 64 MB
MATMUL_SIZE = 1024
PROBE_TILE = "t128x128x64"


def timeit(fn, *args, iters=20, warmup=3) -> float:
    """Seconds per call of fn(*args) on the card (median of `iters`)."""
    return cuda_ms(lambda: fn(*args), warmup=warmup, iters=iters) / 1e3


def build_and_run(fn, *args) -> float:
    """Seconds of the first call, kernel build and load included."""
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def probe_bandwidth() -> dict:
    """Copy 64 MB through the scale-copy kernel (x * 2.0)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(COPY_SHAPE, dtype=np.float32)).cuda()
    print(f"cuda copy build+run: {build_and_run(scale_copy, x):.2f}s", flush=True)
    dt = timeit(scale_copy, x, iters=50)
    gbps = 2 * x.nbytes / dt / 1e9
    print(f"cuda copy 64MB: {dt*1e3:.3f} ms  ({gbps:.1f} GB/s)", flush=True)
    return {"ms": dt * 1e3, "gb_per_s": gbps}


def probe_matmul() -> dict:
    """1024^3 bf16 GEMM with an fp32 out through the tiled kernel."""
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((MATMUL_SIZE, MATMUL_SIZE), dtype=np.float32))
            .to("cuda", torch.bfloat16) for _ in range(2))
    print(f"cuda matmul build+run: {build_and_run(tiled_matmul, a, b, PROBE_TILE):.2f}s",
          flush=True)
    dt = timeit(tiled_matmul, a, b, PROBE_TILE, iters=50)
    tflops = 2 * MATMUL_SIZE ** 3 / dt / 1e12
    print(f"cuda {MATMUL_SIZE}^3 matmul ({PROBE_TILE}): {dt*1e6:.1f} us  ({tflops:.1f} TFLOP/s)",
          flush=True)
    return {"ms": dt * 1e3, "tflops": tflops}


def make_qkv(dtype=torch.bfloat16):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal((B, H, N, HD), dtype=np.float32))
                 .to("cuda", dtype) for _ in range(3))


def attn_xla_current(q, k, v):
    """bf16 scores (bf16 GEMM out) * scale, fp32 softmax, bf16 P.V."""
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(HD))
    probs = torch.softmax(scores.float(), dim=-1).to(torch.bfloat16)
    return torch.matmul(probs, v)


def attn_xla_bf16softmax(q, k, v):
    """fp32 scores, bf16 exponentials over an fp32 sum, bf16 P.V."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(HD))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m).to(torch.bfloat16)
    s = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
    return torch.matmul(e / s.to(torch.bfloat16), v)


def attn_dpa(q, k, v):
    return F.scaled_dot_product_attention(q, k, v)


def attn_nosoftmax(q, k, v):
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(HD))
    return torch.matmul(scores, v)


def attn_bf16_softmax(q, k, v):
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(HD))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def softmax_only(s):
    return torch.softmax(s.float(), dim=-1).to(torch.bfloat16)


def softmax_only_bf16(s):
    return torch.softmax(s, dim=-1)


def bw_probe(x):
    return x * 2.0


def run_main(which: str) -> dict:
    """The JAX script's `main()` for one mode: every line it prints, and
    the numbers as a dict."""
    out: dict = {}
    if which in ("all", "probe"):
        out["copy"] = probe_bandwidth()
        out["matmul"] = probe_matmul()
    if which not in ("all", "xla", "dpa", "pallas"):
        return out
    q, k, v = make_qkv()
    flops = 4 * B * H * N * N * HD

    def line(label, dt, extra=""):
        print(f"{label}: {dt*1e3:.2f} ms/layer ({flops/dt/1e12:.1f} TF/s){extra}", flush=True)
        return dt * 1e3

    if which in ("all", "xla"):
        out["xla_current_ms"] = line("torch current (bf16 scores, fp32 softmax)",
                                     timeit(attn_xla_current, q, k, v))
        out["xla_bf16softmax_ms"] = line("torch flashless bf16 e/sum",
                                         timeit(attn_xla_bf16softmax, q, k, v))
    if which in ("all", "dpa"):
        out["dpa_ms"] = line("F.scaled_dot_product_attention", timeit(attn_dpa, q, k, v))
    if which in ("all", "pallas"):
        print(f"cuda attention_bhnd build+run: {build_and_run(attention_bhnd, q, k, v):.1f}s",
              flush=True)
        err = float((attention_bhnd(q, k, v).float() - attn_xla_current(q, k, v).float())
                    .abs().max())
        out["attention_bhnd_ms"] = line("cuda attention_bhnd, wgmma core",
                                        timeit(attention_bhnd, q, k, v), f" maxerr={err:.4f}")
        out["attention_bhnd_maxerr"] = err
    return out


def extra() -> dict:
    q, k, v = make_qkv()
    flops = 4 * B * H * N * N * HD
    out = {}
    x = torch.ones((64, 1024, 1024), dtype=torch.float32, device="cuda")  # 256 MB
    dt = timeit(bw_probe, x, iters=30)
    out["bw_probe_ms"] = dt * 1e3
    print(f"torch elementwise 256MB r+w: {dt*1e3:.2f} ms ({2*x.nbytes/dt/1e9:.0f} GB/s)",
          flush=True)
    del x
    for key, label, fn in (("nosoftmax", "attn matmuls only (no softmax)", attn_nosoftmax),
                           ("bf16_softmax", "attn full-bf16 softmax", attn_bf16_softmax)):
        dt = timeit(fn, q, k, v)
        out[f"{key}_ms"] = dt * 1e3
        print(f"{label}: {dt*1e3:.2f} ms ({flops/dt/1e12:.1f} TF/s)", flush=True)
    s = torch.ones((B, H, N, N), dtype=torch.bfloat16, device="cuda")
    for key, label, fn in (("softmax_f32", "softmax f32 on [B,H,N,N] bf16", softmax_only),
                           ("softmax_bf16", "softmax bf16 on [B,H,N,N] bf16", softmax_only_bf16)):
        dt = timeit(fn, s)
        out[f"{key}_ms"] = dt * 1e3
        print(f"{label}: {dt*1e3:.2f} ms ({2*s.nbytes/dt/1e9:.0f} GB/s eff)", flush=True)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="all", choices=MODES)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_attn needs a CUDA card")
    print(card_line(), flush=True)
    return extra() if args.mode == "extra" else run_main(args.mode)


if __name__ == "__main__":
    main()
