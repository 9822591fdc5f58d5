# A copy of clibd_tpu/analysis/plots.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Visualization suite (reference scripts/inference_and_eval.py:98-505 +
scripts/result/): 2D embedding plots per taxonomic level with the reference's
taxa filtering (top-N classes, parent-level filters), and query→retrieved
image grids.

The reference uses UMAP + plotly; this environment has neither, so the 2D
projection uses UMAP when importable and falls back to sklearn TSNE (cosine
metric) or PCA; rendering is matplotlib (PNG/PDF).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

LEVELS = ("order", "family", "genus", "species")


def project_2d(features: np.ndarray, random_state: int = 0, method: str = "auto") -> np.ndarray:
    """cosine-metric 2D projection: umap → tsne → pca fallback chain."""
    if method in ("auto", "umap"):
        try:
            from umap import UMAP  # type: ignore

            return UMAP(
                n_components=2, init="random", random_state=random_state,
                min_dist=0.5, metric="cosine",
            ).fit_transform(features)
        except ImportError:
            if method == "umap":
                raise
    if method in ("auto", "tsne") and features.shape[0] > 10:
        try:
            from sklearn.manifold import TSNE

            return TSNE(
                n_components=2, metric="cosine", init="random",
                random_state=random_state,
                perplexity=min(30.0, max(2.0, features.shape[0] / 4 - 1)),
            ).fit_transform(features)
        except Exception:
            pass
    from sklearn.decomposition import PCA

    return PCA(n_components=2, random_state=random_state).fit_transform(features)


def select_plot_indices(
    gt_labels: List[dict],
    level: str,
    parent_filter: Optional[Dict[str, str]] = None,
    num_classes: int = 10,
    seed: int = 0,
) -> List[int]:
    """Reference filtering (inference_and_eval.py:121-140): restrict to the
    configured parent taxon, keep the top-N most frequent classes, shuffle."""
    level_idx = LEVELS.index(level)
    indices = list(range(len(gt_labels)))
    if level_idx > 0 and parent_filter:
        prev = LEVELS[level_idx - 1]
        if prev in parent_filter:
            indices = [i for i in indices if gt_labels[i][prev] == parent_filter[prev]]
    values, counts = np.unique([gt_labels[i][level] for i in indices], return_counts=True)
    top = set(values[np.argsort(-counts)][:num_classes])
    indices = [i for i in indices if gt_labels[i][level] in top]
    rng = random.Random(seed)
    rng.shuffle(indices)
    return indices


def generate_embedding_plot(
    output_dir: str,
    image_features: Optional[np.ndarray],
    dna_features: Optional[np.ndarray],
    language_features: Optional[np.ndarray],
    gt_labels: List[dict],
    embeddings_filters: Optional[Dict[str, str]] = None,
    num_classes: int = 10,
    seed: int = 0,
    formats: Sequence[str] = ("png",),
    max_points: int = 20_000,
) -> List[str]:
    """One scatter per level, colored by class, marker by modality.
    → list of written file paths.

    Deviation from the reference (inference_and_eval.py:108-118, which
    UMAP-projects EVERY record of the split before filtering): the level
    filters (`select_plot_indices` — pure label logic, projection-free) run
    FIRST and only the union of plotted records (capped at `max_points`,
    seeded subsample) is projected.  The reference's order is O(split-size)
    through UMAP — multicore-UMAP-on-a-GPU-host affordable, but this host's
    fallback chain (no umap wheel → sklearn TSNE, 1 core) measured ~50 min
    at 50k×768 rows for points that were then thrown away by the filters.
    Neighbor-embedding plots are qualitative; projecting the plotted subset
    changes only which OTHER points shape the manifold, not the analysis
    semantics (same filters, same classes, same marker/color encoding)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # 1. per-level plotted records (label-only logic — safe before projection)
    level_indices = {
        level: select_plot_indices(gt_labels, level, embeddings_filters, num_classes, seed)
        for level in LEVELS
    }
    sel = sorted(set().union(*level_indices.values())) if gt_labels else []
    if not sel:
        return []
    if len(sel) > max_points:
        rng = np.random.default_rng(seed)
        sel = sorted(rng.choice(np.asarray(sel), max_points, replace=False).tolist())
    kept = set(sel)
    pos = {orig: j for j, orig in enumerate(sel)}
    sel_arr = np.asarray(sel)
    sub_labels = [gt_labels[i] for i in sel]

    feats, names = [], []
    lang_inverse = None
    if language_features is not None:
        uniq, first_idx, inverse = np.unique(
            language_features[sel_arr], axis=0, return_index=True, return_inverse=True
        )
        lang_inverse = inverse  # length len(sel), indexes rows of `uniq`
        language_unique = uniq
    else:
        language_unique = None
    for name, f in (("image", image_features), ("dna", dna_features), ("text", language_unique)):
        if f is not None:
            feats.append(f if name == "text" else f[sel_arr])
            names.append(name)
    if not feats:
        raise ValueError("No image, DNA, or language features provided.")
    proj = project_2d(np.concatenate(feats, axis=0), random_state=seed)
    # slice back per modality
    pieces = {}
    off = 0
    for name, f in zip(names, feats):
        pieces[name] = proj[off : off + len(f)]
        off += len(f)

    os.makedirs(output_dir, exist_ok=True)
    written = []
    markers = {"image": "o", "dna": "^", "text": "s"}
    for level in LEVELS:
        # remap original record indices → rows of the projected subset
        indices = [pos[i] for i in level_indices[level] if i in kept]
        if not indices:
            continue
        classes = sorted({sub_labels[i][level] for i in indices})
        cmap = plt.get_cmap("tab10")
        color_of = {c: cmap(k % 10) for k, c in enumerate(classes)}
        fig, ax = plt.subplots(figsize=(8, 8))
        for name in names:
            if name == "text" and lang_inverse is not None:
                pts = pieces["text"][lang_inverse[indices]]
            else:
                pts = pieces[name][indices]
            colors = [color_of[sub_labels[i][level]] for i in indices]
            ax.scatter(pts[:, 0], pts[:, 1], c=colors, marker=markers[name], s=12,
                       alpha=0.7, label=name, linewidths=0)
        ax.set_title(f"Embeddings by {level}")
        ax.legend(loc="best", fontsize=8)
        for fmt in formats:
            if fmt == "html":
                continue  # one interactive file for all levels, written below
            path = os.path.join(output_dir, f"embedding_{level}.{fmt}")
            fig.savefig(path, dpi=150, bbox_inches="tight")
            written.append(path)
        plt.close(fig)

    if "html" in formats:
        # interactive single-file variant (the reference's plotly HTML plots,
        # inference_and_eval.py:98-220 — here dependency-free canvas JS with
        # a color-by-level dropdown instead of per-level files)
        from .interactive import write_interactive_embedding_plot

        written.append(write_interactive_embedding_plot(
            os.path.join(output_dir, "embedding_interactive.html"),
            pieces, sub_labels, lang_inverse=lang_inverse, seed=seed))
    return written


def retrieve_images_grid(
    output_path: str,
    query_images: List[np.ndarray],
    retrieved_images: List[List[np.ndarray]],
    query_labels: Optional[List[str]] = None,
    retrieved_labels: Optional[List[List[str]]] = None,
    correct: Optional[List[List[bool]]] = None,
) -> str:
    """Query→top-k retrieval figure (reference retrieve_images,
    inference_and_eval.py:223-505): one row per query, first column the query,
    then its neighbours; green/red frame marks correct species."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(query_images)
    k = max(len(r) for r in retrieved_images)
    fig, axes = plt.subplots(n, k + 1, figsize=(1.6 * (k + 1), 1.6 * n), squeeze=False)
    for i in range(n):
        ax = axes[i][0]
        ax.imshow(np.clip(query_images[i], 0, 1))
        ax.set_xticks([]); ax.set_yticks([])
        if query_labels:
            ax.set_title(query_labels[i], fontsize=6)
        for spine in ax.spines.values():
            spine.set_edgecolor("blue"); spine.set_linewidth(2)
        for j in range(k):
            ax = axes[i][j + 1]
            if j < len(retrieved_images[i]):
                ax.imshow(np.clip(retrieved_images[i][j], 0, 1))
                if retrieved_labels:
                    ax.set_title(retrieved_labels[i][j], fontsize=6)
                if correct is not None:
                    color = "green" if correct[i][j] else "red"
                    for spine in ax.spines.values():
                        spine.set_edgecolor(color); spine.set_linewidth(2)
            ax.set_xticks([]); ax.set_yticks([])
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output_path


def plot_confusion_matrix(
    gt: Sequence[str],
    pred: Sequence[str],
    output_path: Optional[str] = None,
    labels: Optional[List[str]] = None,
    normalize: bool = True,
):
    """Reference show_confusion_metrix (epoch/inference_epoch.py:23-40)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.metrics import confusion_matrix

    if labels is None:
        labels = sorted(set(gt))
    cm = confusion_matrix(gt, pred, labels=labels).astype(np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(12, 12))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(labels)), labels, rotation=30, fontsize=7)
    ax.set_yticks(range(len(labels)), labels, fontsize=7)
    ax.set_xlabel("Predicted"); ax.set_ylabel("Ground Truth"); ax.set_title("Confusion Matrix")
    fig.colorbar(im)
    if output_path:
        fig.savefig(output_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return output_path
    return fig


# ---------------------------------------------------------------------------
# Subset confusion matrices (reference scripts/result/create_confusion_matrix
# .py:42-113): 10 most-common and 10 most-confused classes per (split,
# query→key, taxonomic level), annotated row-normalized heatmaps
# ---------------------------------------------------------------------------

CONFUSION_PAIRS = (
    ("encoded_image_feature", "encoded_image_feature"),
    ("encoded_dna_feature", "encoded_dna_feature"),
    ("encoded_image_feature", "encoded_dna_feature"),
)


def _annotated_heatmap(cm, classes, title, output_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10))
    im = ax.imshow(cm, cmap="Blues", vmin=0.0, vmax=max(1.0, float(cm.max())))
    mid = (cm.max() + cm.min()) / 2 if cm.size else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{cm[i, j]:.2f}", ha="center", va="center", fontsize=7,
                    color="white" if cm[i, j] > mid else "black")
    ax.set_xticks(range(len(classes)), classes, rotation=45, ha="right", fontsize=7)
    ax.set_yticks(range(len(classes)), classes, fontsize=7)
    ax.set_xlabel("Predicted label"); ax.set_ylabel("True label")
    ax.set_title(title, fontsize=10)
    fig.colorbar(im, shrink=0.7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def most_common_class_indices(cm: np.ndarray, top_n: int = 10) -> np.ndarray:
    """Classes ranked by raw correct-prediction count (the reference ranks by
    the unnormalized diagonal, create_confusion_matrix.py:65-67)."""
    return np.argsort(-np.diag(cm), kind="stable")[:top_n]


def most_confused_class_indices(cm_normalized: np.ndarray, top_n: int = 10) -> list:
    """Classes involved in the largest off-diagonal normalized confusions
    (create_confusion_matrix.py:79-91): walk cell pairs in descending order,
    collect both endpoints until >= top_n unique classes, sorted, truncated."""
    masked = cm_normalized.copy()
    np.fill_diagonal(masked, -np.inf)
    order = np.dstack(np.unravel_index(np.argsort(-masked, axis=None, kind="stable"),
                                       masked.shape))[0]
    unique: set = set()
    for i, j in order:
        unique.update((int(i), int(j)))
        if len(unique) >= top_n:
            break
    return sorted(unique)[:top_n]


def plot_subset_confusion_matrices(
    pred_dict: dict,
    output_dir: str,
    query_key_pairs=CONFUSION_PAIRS,
    levels=("order", "family", "genus", "species"),
    top_n: int = 10,
) -> List[str]:
    """For each (seen/unseen split, query→key pair, taxonomic level) present
    in a cached pred_dict payload, write the most-common-classes and
    most-confused-classes heatmaps (reference plot_confusion_matrix,
    create_confusion_matrix.py:99-113)."""
    from sklearn.metrics import confusion_matrix

    short = {"encoded_image_feature": "image", "encoded_dna_feature": "DNA",
             "encoded_language_feature": "text"}
    paths = []
    for split in ("seen", "unseen"):
        gt_list = pred_dict.get(f"{split}_gt_label")
        if not gt_list:
            continue
        for query, key in query_key_pairs:
            cell = pred_dict.get(query, {}).get(key)
            if not cell:
                continue
            pred_list = cell[f"curr_{split}_pred_list"]
            for level in levels:
                y_pred = [p[level][0] for p in pred_list]
                y_true = [g[level] for g in gt_list]
                # Deliberate deviation from the reference (which passes only
                # set(y_true) as labels, create_confusion_matrix.py:110):
                # sklearn drops every sample whose prediction falls outside
                # the label set, so e.g. unseen-split queries predicted as
                # seen species vanish and the row normalization inflates the
                # diagonal.  Using the union keeps those confusions (pred-only
                # classes get all-zero rows that never rank as most-common,
                # since their diagonal count is 0).
                classes = sorted(set(y_true) | set(y_pred))
                cm = confusion_matrix(y_true, y_pred, labels=classes)
                with np.errstate(invalid="ignore", divide="ignore"):
                    cm_norm = np.nan_to_num(cm.astype(np.float64) /
                                            cm.sum(axis=1, keepdims=True))
                pair = f"{short.get(query, query)}_to_{short.get(key, key)}"
                common = most_common_class_indices(cm, top_n)
                paths.append(_annotated_heatmap(
                    cm_norm[np.ix_(common, common)],
                    [classes[i] for i in common],
                    f"Most common classes {split} {pair} at {level}",
                    os.path.join(output_dir,
                                 f"confusion_common_{split}_{pair}_{level}.png")))
                confused = most_confused_class_indices(cm_norm, top_n)
                paths.append(_annotated_heatmap(
                    cm_norm[np.ix_(confused, confused)],
                    [classes[i] for i in confused],
                    f"Most confused classes {split} {pair} at {level}",
                    os.path.join(output_dir,
                                 f"confusion_confused_{split}_{pair}_{level}.png")))
    return paths
