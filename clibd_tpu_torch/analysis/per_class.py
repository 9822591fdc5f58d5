# A copy of clibd_tpu/analysis/per_class.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Per-class accuracy analysis + dataset sanity checks (reference
scripts/result/{quick_script_for_acc, per_class_acc_analyze, class_statistic,
check_unique_barcode_and_bin_number}.py)."""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def recompute_acc_from_predictions(predictions: Sequence[str],
                                   ground_truths: Sequence[str]) -> Tuple[float, float]:
    """(micro, macro) accuracy recomputed from saved top-1 predictions
    (reference quick_script_for_acc.calculate_accuracies:27-44)."""
    preds = np.asarray(predictions)
    gts = np.asarray(ground_truths)
    micro = float((preds == gts).mean()) if len(gts) else 0.0
    per_class = []
    for cls in set(ground_truths):
        m = gts == cls
        per_class.append(float((preds[m] == cls).mean()))
    macro = float(np.mean(per_class)) if per_class else 0.0
    return micro, macro


def avg_acc_by_key_count(count_list: Sequence[int], acc_list: Sequence[float]) -> Dict[int, float]:
    """Mean accuracy of classes grouped by their key-set record count
    (reference per_class_acc_analyze.get_avg_acc_by_key_count:20-33)."""
    buckets: Dict[int, List[float]] = {}
    for c, a in zip(count_list, acc_list):
        buckets.setdefault(int(c), []).append(float(a))
    return {c: float(np.mean(v)) for c, v in sorted(buckets.items())}


def average_acc_for_species_membership(
    per_class_acc: Dict[str, float],
    species_list: Sequence[str],
) -> Dict[str, Optional[float]]:
    """Average per-class accuracy split by membership in `species_list`
    (e.g. the 1M training-species list), after the reference's lowercase/
    underscore normalization (logs/check_per_class_acc.py:9-37).
    → {'in_list': avg|None, 'not_in_list': avg|None, counts...}."""
    norm = lambda s: s.lower().replace(" ", "_")
    members = {norm(s) for s in species_list}
    in_list, out_list = [], []
    for species, acc in per_class_acc.items():
        (in_list if norm(species) in members else out_list).append(float(acc))
    return {
        "in_list": float(np.mean(in_list)) if in_list else None,
        "not_in_list": float(np.mean(out_list)) if out_list else None,
        "n_in_list": len(in_list),
        "n_not_in_list": len(out_list),
    }


def per_class_acc_vs_key_count(
    per_class_acc: Dict[str, float],
    key_label_dicts: Sequence[dict],
    level: str = "species",
) -> Tuple[List[int], List[float]]:
    """Pair each class's accuracy with its record count in the key gallery."""
    counts = Counter(d[level] for d in key_label_dicts)
    xs, ys = [], []
    for cls, acc in per_class_acc.items():
        xs.append(int(counts.get(cls, 0)))
        ys.append(float(acc))
    return xs, ys


def plot_per_class_acc_vs_key_count(
    per_class_acc_by_combo: Dict[str, Dict[str, float]],
    key_label_dicts: Sequence[dict],
    output_path: str,
    level: str = "species",
) -> str:
    """Scatter of per-class accuracy vs key-set record count, one panel per
    query→key combination, with the bucket-averaged trend line (reference
    per_class_acc_analyze.plot_multiple_scatterplot:89-127)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    combos = list(per_class_acc_by_combo)
    fig, axes = plt.subplots(1, max(len(combos), 1),
                             figsize=(4.2 * max(len(combos), 1), 3.6), squeeze=False)
    for i, combo in enumerate(combos):
        ax = axes[0][i]
        xs, ys = per_class_acc_vs_key_count(per_class_acc_by_combo[combo],
                                            key_label_dicts, level=level)
        ax.scatter(xs, ys, s=8, alpha=0.4)
        trend = avg_acc_by_key_count(xs, ys)
        ax.plot(list(trend.keys()), list(trend.values()), color="tab:red", lw=1.5)
        ax.set_title(combo, fontsize=8)
        ax.set_xlabel(f"records per {level} in keys", fontsize=8)
        if i == 0:
            ax.set_ylabel("per-class top-1 acc", fontsize=8)
        ax.set_ylim(-0.02, 1.02)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def unique_counts_summary(hdf5_path: str,
                          splits: Optional[Sequence[str]] = None,
                          fields: Sequence[str] = ("barcode", "dna_bin", "species")) -> Dict[str, Dict[str, int]]:
    """Unique barcode / dna_bin / species counts per split (reference
    check_unique_barcode_and_bin_number.py).  Missing fields are skipped."""
    import h5py

    out: Dict[str, Dict[str, int]] = {}
    with h5py.File(hdf5_path, "r") as f:
        names = splits if splits is not None else list(f.keys())
        for split in names:
            if split not in f:
                continue
            g = f[split]
            entry = {}
            for field in fields:
                if field not in g:
                    continue
                vals = [v.decode() if isinstance(v, bytes) else str(v) for v in g[field][...]]
                entry[f"unique_{field}"] = len(set(vals))
            out[split] = entry
    return out


def pretrain_seen_unseen_overlap(hdf5_path: str, level: str = "species",
                                 pretrain_split: str = "no_split",
                                 seen_split: str = "seen_keys",
                                 unseen_splits: Sequence[str] = ("val_unseen_keys", "test_unseen_keys")) -> Dict[str, int]:
    """How many of the pretrain split's classes are seen/unseen/overlapping
    (reference class_statistic.show_pretrain_data_seen_unseen_overlap:8-30)."""
    import h5py

    def classes(g, name):
        return {v.decode() if isinstance(v, bytes) else str(v) for v in g[name][level][...]}

    with h5py.File(hdf5_path, "r") as f:
        if pretrain_split not in f or seen_split not in f:
            return {}
        seen = classes(f, seen_split)
        unseen = set()
        for s in unseen_splits:
            if s in f:
                unseen |= classes(f, s)
        pre = classes(f, pretrain_split)
    seen_in_pre = seen & pre
    unseen_in_pre = unseen & pre
    return {
        "pretrain_classes": len(pre),
        "seen_in_pretrain": len(seen_in_pre),
        "unseen_in_pretrain": len(unseen_in_pre),
        "overlap_in_pretrain": len(seen_in_pre & unseen_in_pre),
    }
