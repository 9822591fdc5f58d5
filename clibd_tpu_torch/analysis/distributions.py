# A copy of clibd_tpu/analysis/distributions.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Similarity-distribution analysis (reference scripts/result/
distribution_of_similarities.py): for every query, the smallest L2 distance
to a same-species key, per (query-feature, key-feature) modality combination;
plus per-level silhouette scores.

TPU-framework note: the reference walks a python double loop over queries ×
same-species keys (O(Q·K) numpy calls); here each species group is one
[q, d] × [k, d] distance matrix (vectorized, ~100× fewer interpreter trips).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

MODALITY_FEATURES = (
    "encoded_image_feature",
    "encoded_dna_feature",
    "encoded_language_feature",
)


def _pairwise_min_dist(q: np.ndarray, k: np.ndarray) -> np.ndarray:
    """min over keys of ||q_i - k_j|| → [Q]."""
    d2 = (
        (q * q).sum(1)[:, None]
        - 2.0 * q @ k.T
        + (k * k).sum(1)[None, :]
    )
    return np.sqrt(np.maximum(d2.min(axis=1), 0.0))


def nearest_same_species_distances(
    keys_dict: Dict,
    query_dict: Dict,
    features: Sequence[str] = MODALITY_FEATURES,
    level: str = "species",
) -> List[dict]:
    """→ one row per query: taxonomy + `distance_for_<q>_to_<k>` columns
    (reference get_similarity_for_different_combination_of_modalities).
    Queries whose species has no key are skipped (the reference KeyErrors)."""
    key_species = np.array([l[level] for l in keys_dict["label_list"]])
    q_species = np.array([l[level] for l in query_dict["label_list"]])
    present = [f for f in features if keys_dict.get(f) is not None and query_dict.get(f) is not None]

    key_groups = {}
    for s in np.unique(key_species):
        key_groups[s] = np.nonzero(key_species == s)[0]

    rows: List[dict] = [None] * len(q_species)  # type: ignore
    for s in np.unique(q_species):
        if s not in key_groups:
            continue
        q_idx = np.nonzero(q_species == s)[0]
        k_idx = key_groups[s]
        dists = {}
        for qf in present:
            for kf in present:
                if query_dict[qf].shape[-1] != keys_dict[kf].shape[-1]:
                    continue
                dists[(qf, kf)] = _pairwise_min_dist(
                    np.asarray(query_dict[qf])[q_idx], np.asarray(keys_dict[kf])[k_idx]
                )
        for row_pos, qi in enumerate(q_idx):
            row = {
                "file_name": query_dict["processed_id_list"][qi],
                **query_dict["label_list"][qi],
            }
            for (qf, kf), d in dists.items():
                qname = qf.replace("encoded_", "").replace("_feature", "")
                kname = kf.replace("encoded_", "").replace("_feature", "")
                row[f"distance_for_{qname}_to_{kname}"] = float(d[row_pos])
            rows[qi] = row
    return [r for r in rows if r is not None]


def similarity_distribution_rows(keys_dict: Dict, seen_dict: Dict, unseen_dict: Dict) -> List[dict]:
    """seen+unseen rows with a `split` column (reference list_of_query_info)."""
    out = []
    for split, qd in (("seen", seen_dict), ("unseen", unseen_dict)):
        for row in nearest_same_species_distances(keys_dict, qd):
            row["split"] = split
            out.append(row)
    return out


def plot_similarity_distributions(
    rows: List[dict],
    output_path: str,
    columns: Optional[List[str]] = None,
) -> str:
    """Histogram per distance column, seen vs unseen overlaid (reference's
    distribution plots)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if columns is None:
        columns = sorted({k for r in rows for k in r if k.startswith("distance_for_")})
    ncols = min(3, max(len(columns), 1))
    nrows = -(-len(columns) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, col in enumerate(columns):
        ax = axes[i // ncols][i % ncols]
        for split, color in (("seen", "tab:blue"), ("unseen", "tab:orange")):
            vals = [r[col] for r in rows if r.get("split") == split and col in r]
            if vals:
                ax.hist(vals, bins=40, alpha=0.5, label=split, color=color, density=True)
        ax.set_title(col.replace("distance_for_", ""), fontsize=9)
        ax.legend(fontsize=7)
    for j in range(len(columns), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def write_distance_csv(rows: List[dict], output_path: str) -> str:
    import csv

    cols = sorted({k for r in rows for k in r})
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    return output_path


def silhouette_summary(features: np.ndarray, label_dicts: List[dict],
                       levels: Sequence[str] = ("order", "family", "genus", "species")) -> Dict[str, float]:
    """Mean silhouette score per taxonomic level (reference
    calculate_silhouette_score, distribution_of_similarities.py:34-38).
    Levels with fewer than 2 classes score nan."""
    from sklearn.metrics import silhouette_samples

    out = {}
    for level in levels:
        gt = [l[level] for l in label_dicts]
        if len(set(gt)) < 2 or len(set(gt)) >= len(gt):
            out[level] = float("nan")
            continue
        out[level] = float(np.mean(silhouette_samples(features, gt)))
    return out
