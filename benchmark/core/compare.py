"""The numbers `correct` compares, each beside its limit.

Training (the program's first steps against the plain reference's from the
same weights and batches):
- `loss_gap`: the largest |loss − reference loss| / |reference loss| over
  the steps followed;
- `grad_gap`: the first gradient, as the optimizer holds it after one step,
  by the worst leaf: |‖g‖ − ‖g_ref‖| over the larger of the reference's
  norm of that leaf and of the median leaf;
- `grad_dir_gap`: the same gradient's direction, by the worst leaf:
  1 − cos(g, g_ref), over the leaves whose reference gradient's norm is at
  least a thousandth of the median leaf's (`direction_gaps`).  Under Adam
  the change and its norm hardly depend on the gradient's size, and a
  tower's gradient scale swings with rounding at this init; its direction
  is what a backward computed wrongly, or gradients not averaged over the
  ranks, change;
- `change_gap`: the parameters' change after the steps followed, by the
  worst leaf in the same measure, over the elements whose first reference
  gradient is at least a thousandth of the median leaf's root mean square
  (`moved_change_norms`): an element whose gradient is nought to rounding, as a
  key's bias is under the softmax, moves under Adam by round-off alone.

- `<modality>_gap`: the first step's unit features, as below.

Embedding (and the first train step's features): `<modality>_gap`, the
largest distance between the program's unit embedding of a row and the
reference's of the same row, over every row.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

ROUNDOFF_SHARE = 1e-3


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return max(leaf_gaps(prog, ref).values())


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap in `worst_leaf_gap`'s measure."""
    median = float(np.median(list(ref.values())))
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median) for n in ref}


def moved_change_norms(prog_change: dict, ref_change: dict, ref_grad: dict):
    """Per-leaf norms of the two changes (tensors) over the elements whose
    reference gradient (tensors) is at least ROUNDOFF_SHARE of the median
    leaf's root mean square; leaves with no such element left out."""
    import torch

    rms = [float(torch.linalg.vector_norm(g.double())) / max(g.numel(), 1) ** 0.5
           for g in ref_grad.values()]
    floor = ROUNDOFF_SHARE * float(np.median(rms))
    prog, ref = {}, {}
    for n, g in ref_grad.items():
        keep = g.abs() >= floor
        if bool(keep.any()):
            prog[n] = float(torch.linalg.vector_norm(prog_change[n].to(g.device)[keep].double()))
            ref[n] = float(torch.linalg.vector_norm(ref_change[n][keep].double()))
    return prog, ref


def direction_gaps(prog_grad: dict, ref_grad: dict) -> Dict[str, float]:
    """1 − cos(g, g_ref) of each leaf (tensors) whose reference gradient's
    norm is at least ROUNDOFF_SHARE of the median leaf's; a leaf the program
    lacks reads 1."""
    import torch

    norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in ref_grad.items()}
    floor = ROUNDOFF_SHARE * float(np.median(list(norms.values())))
    out = {}
    for n, g in ref_grad.items():
        if norms[n] < floor:
            continue
        got = prog_grad.get(n)
        if got is None:
            out[n] = 1.0
            continue
        a, b = got.to(g.device).double().flatten(), g.double().flatten()
        denom = float(torch.linalg.vector_norm(a)) * norms[n]
        out[n] = 1.0 - (float(a @ b) / denom if denom > 0 else 0.0)
    return out


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"losses": [...], "grad": {leaf: norm}, "grad_t": {leaf:
    tensor}, "change": {leaf: norm}} over the same steps, the changes'
    norms from `moved_change_norms`."""
    steps = len(ref["losses"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][:steps], ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf_gap(prog["grad"], ref["grad"]),
            "grad_dir_gap": max(direction_gaps(prog["grad_t"], ref["grad_t"]).values()),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"])}


def row_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """prog[m] [R, d] the program's rows, ref[m] [R, d] the reference's rows
    in the same order → {m + "_gap": the largest row distance}; infinite
    where the program returned another number of rows."""
    out = {}
    for m in ref:
        got = prog.get(m)
        if got is None or got.shape != ref[m].shape:
            out[f"{m}_gap"] = float("inf")
        else:
            out[f"{m}_gap"] = float(np.sqrt(((got.astype(np.float64) - ref[m]) ** 2)
                                            .sum(axis=1)).max())
    return out


NOT_COMPARED = "not compared"


def judge(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """{name: {"value", "limit", "ok"}}.  A number fails above its limit,
    where it is not finite, or where the checks give it no limit; one whose
    limit is "not compared" is printed and not judged."""
    out = {}
    for name, value in numbers.items():
        limit = limits.get(name)
        if limit == NOT_COMPARED:
            ok = True
        else:
            ok = isinstance(limit, (int, float)) and bool(np.isfinite(value)) and value <= limit
        out[name] = {"value": float(value), "limit": limit, "ok": bool(ok)}
    return out
