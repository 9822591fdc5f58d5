"""The tiled GEMM, C = A . B with bf16 operands and an fp32 accumulator:
the port of three Pallas kernels that compute this product,
`tools/exp_attn.py::probe_pallas_matmul` (one program, 1024^3),
`tools/exp_mxu.py::make_tiled` (2048^3) and `tools/exp_mxu2.py::make_tiled`
(8192^3, fp32 or bf16 out, a tile sweep).

`tiled_matmul(a, b, tile, out_dtype)` takes a [M, K] and b [K, N], both
bf16 and row-major as in the TPU kernels, and returns C [M, N] in
`out_dtype` (fp32 or bf16).  `tile` names one of `TILES`, the shapes the
kernel (`csrc/tiled_gemm.cu`) is built for; M, N and K must be multiples of
the tile's (BM, BN, BK), as the TPU grid (`M // tm`) requires, and any other
shape raises, on the CPU too.  On a CUDA tensor it launches the hand-written
kernel for that tile; on a CPU tensor it runs the plain version,
`tiled_matmul_reference`.  There is no fallback from the card to the plain
version: a build or launch error raises.

Numerics: the products of bf16 values are exact in fp32, so kernel and
plain version differ only in the order of the fp32 sums (and, for bf16 out,
in a final rounding that such a difference can flip).

Deliberately absent (TPU-only): the TPU tiles themselves (tm, tn 256-1024,
tk 512-2048: VMEM blocks whose fp32 accumulator would be a 1 MB per CTA
here; `TILES` asks the same question of tile shape in Hopper terms, each
slot of K 64 deep, one 128-byte swizzled row), `dimension_semantics`
(`exp_mxu2.py:53-55`: the CTAs of a CUDA grid are independent by
construction) and `pl.dot` against `jnp.dot`
(`exp_mxu.py:41-44`: one product instruction here).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Tuple

import torch

from .cuda_build import DTYPE_CODE, launch

# name -> (BM, BN, BK, warps, stages); mirrors CLIBD_GEMM_TILE in
# csrc/tiled_gemm.cu: 4 warps a consumer warpgroup and a producer warp a CTA;
# the `_c2` tile is a cluster of two CTAs stacked along M, BM rows together
TILES: Dict[str, Tuple[int, int, int, int, int]] = {
    "t64x64x64": (64, 64, 64, 5, 4),
    "t128x128x64": (128, 128, 64, 9, 6),
    "t128x256x64": (128, 256, 64, 9, 4),
    "t256x128x64": (256, 128, 64, 9, 4),
    "t256x256x64_c2": (256, 256, 64, 9, 4),
}
OUT_DTYPES = (torch.float32, torch.bfloat16)


@contextmanager
def _full_fp32_matmul():
    """fp32 matmuls in full fp32 (no TF32) for the duration, then restored."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def tiled_matmul_reference(a: torch.Tensor, b: torch.Tensor,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the bf16 values multiplied in
    fp32 with TF32 off (exact products, fp32 sums), cast to `out_dtype`."""
    with _full_fp32_matmul():
        return torch.matmul(a.float(), b.float()).to(out_dtype)


def check_shapes(a: torch.Tensor, b: torch.Tensor, tile: str, out_dtype: torch.dtype) -> None:
    """Raise on what the kernel does not take: an unknown tile, a dtype other
    than bf16 in and fp32/bf16 out, or a shape off the tile."""
    if tile not in TILES:
        raise ValueError(f"tiled_matmul: tile {tile!r} is not one of {sorted(TILES)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or out_dtype not in OUT_DTYPES:
        raise TypeError(f"tiled_matmul: a {a.dtype}, b {b.dtype}, out {out_dtype} (bf16 in, "
                        "fp32 or bf16 out)")
    bm, bn, bk = TILES[tile][:3]
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul: a {tuple(a.shape)} and b {tuple(b.shape)} are not "
                         "[M, K] and [K, N]")
    M, K = a.shape
    N = b.shape[1]
    if M % bm or N % bn or K % bk or not min(M, N, K):
        raise ValueError(f"tiled_matmul: M={M}, N={N}, K={K} are not positive multiples of "
                         f"the tile {tile} ({bm}, {bn}, {bk})")


def tiled_matmul_cuda(a: torch.Tensor, b: torch.Tensor, tile: str,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the kernel of `tile` → C [M, N] in `out_dtype`."""
    check_shapes(a, b, tile, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"tiled_matmul: no kernel for a on {a.device} and b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()) or (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("tiled_matmul: a and b must be contiguous and 16-byte aligned")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    launch("tiled_matmul", "tiled_gemm", f"clibd_tiled_gemm_{tile}",
           [a.data_ptr(), b.data_ptr(), out.data_ptr()], [M, N, K, DTYPE_CODE[out_dtype]],
           a.device)
    tiled_matmul.launches += 1
    return out


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, tile: str,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a [M, K] . b [K, N] (bf16) with an fp32 accumulator → [M, N] in
    `out_dtype`: the kernel of `tile` on a CUDA tensor, the plain version on
    a CPU tensor (after the same shape checks)."""
    if a.device.type == "cpu":
        check_shapes(a, b, tile, out_dtype)
        return tiled_matmul_reference(a, b, out_dtype)
    return tiled_matmul_cuda(a, b, tile, out_dtype)


# launches of the kernel (every tile), counted where the wrapper launches it
tiled_matmul.launches = 0
