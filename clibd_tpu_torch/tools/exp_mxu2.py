"""GEMM rate of the hand-written tiled kernel at 8192^3 bf16: the port of the
experiment script `tools/exp_mxu2.py`.

    python -m clibd_tpu_torch.tools.exp_mxu2 [variant ...]

The variants (`VARIANTS`; all of them when none is named) are `cublas`
(`torch.matmul` on bf16, the counterpart of the JAX script's `xla` row) and,
for every tile of `ops/gemm.TILES`, `<tile>` (fp32 out) and
`<tile>_bf16out`.  Each prints its maxerr against the plain version
(`tiled_matmul_reference`: exact products summed in fp32, computed once)
and `ms (TF/s)`, as the JAX script does.  The JAX script's question -- can
a hand-written kernel approach the library's rate, so that a fused
out-projection or an MLP megakernel becomes a win? -- is asked of this card.
Its TPU tiles (tm, tn 256-1024, tk 512-2048) and `dimension_semantics` have
no counterpart: `TILES` sweeps tile shape in Hopper terms, and
the CTAs of a CUDA grid are independent by construction.  Device times by
CUDA events (`utils/profiling.cuda_ms`); inputs seeded with numpy as in the
JAX script.  Needs a CUDA card and raises without one; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.gemm import TILES
from ..utils.profiling import card_line
from . import exp_mxu

M = N = K = 8192
VARIANTS: Dict[str, Optional[Tuple[str, torch.dtype]]] = {"cublas": None}
for _tile in TILES:
    VARIANTS[_tile] = (_tile, torch.float32)
    VARIANTS[f"{_tile}_bf16out"] = (_tile, torch.bfloat16)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    args = ap.parse_args(argv)
    unknown = [n for n in args.variants if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    return args


def main(argv=None) -> List[dict]:
    names = parse_args(argv).variants or list(VARIANTS)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_mxu2 needs a CUDA card")
    print(card_line(), flush=True)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to("cuda", torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to("cuda", torch.bfloat16)
    rows = []
    if "cublas" in names:
        rows.append(exp_mxu.report("cublas", exp_mxu.timeit(torch.matmul, a, b), 2 * M * N * K,
                                   in_ms=True))
    return rows + exp_mxu.sweep(a, b, [VARIANTS[n] for n in names if VARIANTS[n] is not None],
                                in_ms=True)


if __name__ == "__main__":
    main()
