# A copy of clibd_tpu/utils/metrics.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Retrieval metrics: micro/macro top-k accuracy over taxonomic levels.

Semantics match the reference exactly (bioscanclip/util/util.py:379-395
`top_k_micro_accuracy`, :555-599 `top_k_macro_accuracy`):

- micro top-k at a level = fraction of queries whose ground-truth label
  appears among the first k retrieved neighbours' labels at that level.
- macro top-k = unweighted mean over ground-truth classes of per-class hit
  rate; `per_class_acc` exposes the per-class rates.

Unlike the reference's per-sample Python loops, these are vectorized numpy
computations over [N, max_k] prediction matrices.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

LEVELS = ("order", "family", "genus", "species")


def top_k_micro_accuracy(
    pred_by_level: Dict[str, np.ndarray],
    gt_by_level: Dict[str, np.ndarray],
    k_list: Sequence[int] = (1, 3, 5),
) -> dict:
    """Returns {k: {level: acc}} like the reference."""
    out: dict = {k: {} for k in k_list}
    max_k = max(k_list)
    for level in LEVELS:
        pred = np.asarray(pred_by_level[level])
        gt = np.asarray(gt_by_level[level])
        if len(gt) == 0:
            for k in k_list:
                out[k][level] = 0.0
            continue
        # the object-array equality over [N, max_k] is the expensive op at
        # 40k-query scale — compute it ONCE per level and slice per k
        eq = pred[:, :max_k] == gt[:, None]
        for k in k_list:
            out[k][level] = float(eq[:, :k].any(axis=1).mean())
    return out


def top_k_macro_accuracy(
    pred_by_level: Dict[str, np.ndarray],
    gt_by_level: Dict[str, np.ndarray],
    k_list: Sequence[int] = (1, 3, 5),
) -> tuple:
    """Returns (macro_acc {k: {level: acc}}, per_class_acc {k: {level: {label: acc}}})."""
    macro: dict = {k: {} for k in k_list}
    per_class: dict = {k: {} for k in k_list}
    max_k = max(k_list)
    for level in LEVELS:
        pred = np.asarray(pred_by_level[level])
        gt = np.asarray(gt_by_level[level])
        if len(gt) == 0:
            for k in k_list:
                macro[k][level] = 0.0
                per_class[k][level] = {}
            continue
        # hoist the two expensive per-level ops out of the k loop: the
        # object-string unique/sort and the [N, max_k] equality matrix
        eq = pred[:, :max_k] == gt[:, None]
        classes, inv = np.unique(gt, return_inverse=True)
        gt_counts = np.bincount(inv, minlength=len(classes))
        class_names = [str(c) for c in classes]
        for k in k_list:
            hits = eq[:, :k].any(axis=1)
            hit_counts = np.bincount(inv, weights=hits.astype(np.float64),
                                     minlength=len(classes))
            rates = hit_counts / gt_counts
            macro[k][level] = float(rates.mean())
            per_class[k][level] = dict(zip(class_names, map(float, rates)))
    return macro, per_class


def harmonic_mean(a: float, b: float) -> float:
    """Seen/unseen fusion metric (reference scripts/method_nn.py:128-135)."""
    if a + b == 0:
        return 0.0
    return 2.0 * a * b / (a + b)


def labels_to_level_arrays(label_list: List[dict]) -> Dict[str, np.ndarray]:
    """Convert the reference's list-of-taxon-dicts into per-level arrays."""
    return {level: np.asarray([lab[level] for lab in label_list], dtype=object) for level in LEVELS}


def predictions_to_level_arrays(
    indices: np.ndarray, key_labels_by_level: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Map kNN neighbour indices [N, max_k] to per-level label matrices."""
    return {level: np.asarray(key_labels_by_level[level], dtype=object)[indices] for level in LEVELS}
