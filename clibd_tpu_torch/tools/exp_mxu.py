"""Can a hand-written kernel reach this card's tensor cores?  The port of
the experiment script `tools/exp_mxu.py`: C = A . B at 2048^3, bf16 in.

    python -m clibd_tpu_torch.tools.exp_mxu

Times cuBLAS (`torch.matmul` on bf16, the counterpart of the JAX script's
`xla dot` row) and then every tile of the tiled GEMM kernel
(`ops/gemm.TILES`, `ops/gemm.tiled_matmul`) with an fp32 and a bf16 out,
each with its maxerr against the plain version (`tiled_matmul_reference`,
exact products summed in fp32) and `us (TF/s)`, as the JAX script prints
them.  The JAX script's `pl.dot` against `jnp.dot` rows have no counterpart
(one product instruction here).  Device times by CUDA events
(`utils/profiling.cuda_ms`); inputs seeded with numpy as in the JAX script.
Needs a CUDA card and raises without one; prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np
import torch

from ..ops.gemm import OUT_DTYPES, TILES, tiled_matmul, tiled_matmul_reference
from ..utils.profiling import card_line
from .exp_attn import timeit

M = N = K = 2048
# (tile, out dtype): every tile with both outs
VARIANTS: List[Tuple[str, torch.dtype]] = [(t, d) for t in TILES for d in OUT_DTYPES]
DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def report(name: str, dt: float, flops: float = 2 * M * N * K, in_ms: bool = False) -> dict:
    """Print `name: time (TF/s)` in us (in ms for `in_ms`, as exp_mxu2) →
    the row."""
    tflops = flops / dt / 1e12
    if in_ms:
        print(f"{name:44s}: {dt*1e3:8.2f} ms ({tflops:6.1f} TF/s)", flush=True)
    else:
        print(f"{name:34s}: {dt*1e6:9.1f} us ({tflops:6.1f} TF/s)", flush=True)
    return {"name": name, "ms": dt * 1e3, "tflops": tflops}


def sweep(a: torch.Tensor, b: torch.Tensor, variants, in_ms: bool = False) -> List[dict]:
    """Build, check and time each (tile, out dtype) on a, b; → one row each
    with ms, TF/s and maxerr (and max|plain|) against the plain version."""
    flops = 2 * a.shape[0] * a.shape[1] * b.shape[1]
    ref = tiled_matmul_reference(a, b)
    ref_max = float(ref.abs().max())
    rows = []
    for tile, dtype in variants:
        t0 = time.perf_counter()
        o = tiled_matmul(a, b, tile, dtype)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        err = float((o.float() - ref.to(dtype).float()).abs().max())
        del o
        print(f"  build+run {build_s:.1f}s maxerr {err:.4f} (max|plain| {ref_max:.1f})",
              flush=True)
        row = report(f"cuda tiled {tile} {DTYPE_NAME[dtype]} out",
                     timeit(tiled_matmul, a, b, tile, dtype), flops, in_ms)
        rows.append({**row, "tile": tile, "out": DTYPE_NAME[dtype], "maxerr": err,
                     "max_plain": ref_max})
    return rows


def main(argv=None) -> List[dict]:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_mxu needs a CUDA card")
    print(card_line(), flush=True)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to("cuda", torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to("cuda", torch.bfloat16)
    rows = [report("torch.matmul bf16 (cuBLAS)", timeit(torch.matmul, a, b))]
    return rows + sweep(a, b, VARIANTS)


if __name__ == "__main__":
    main()
