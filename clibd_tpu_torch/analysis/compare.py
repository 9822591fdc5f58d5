# A copy of clibd_tpu/analysis/compare.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Multi-experiment comparison plots (reference scripts/result/
comparing_multi_experiment_results_in_same_plot[_all_in_one].py): accuracy vs
taxonomy level, one line per experiment, micro/macro × seen/unseen panels;
plus the harmonic-mean column the reference adds before plotting."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from ..utils.metrics import harmonic_mean

LEVELS = ("order", "family", "genus", "species")


def add_harmonic_mean_acc(acc_dict: Dict) -> Dict:
    """Add a 'harmonic_mean' pseudo-split combining seen/unseen accuracies per
    (query_type, key_type, metric, k, level) — reference
    add_harmonic_mean_acc_to_dict (comparing_multi_experiment_results...py:100-118).
    acc_dict nesting: [query_type][key_type][seen|unseen][metric][k][level]."""
    for qtype in acc_dict.values():
        for splits in qtype.values():
            if "harmonic_mean" in splits:
                continue  # idempotent — callers may pre-process the dict
            seen = splits.get("seen")
            unseen = splits.get("unseen")
            if not (isinstance(seen, dict) and isinstance(unseen, dict)):
                continue
            hm: Dict = {}
            for metric, ks in seen.items():
                if metric not in unseen or not isinstance(ks, dict):
                    continue
                hm[metric] = {}
                for k, levels in ks.items():
                    if k not in unseen[metric]:
                        continue
                    hm[metric][k] = {
                        lvl: harmonic_mean(levels[lvl], unseen[metric][k][lvl])
                        for lvl in levels
                        if lvl in unseen[metric][k]
                    }
            splits["harmonic_mean"] = hm
    return acc_dict


def _series(acc_dict: Dict, query_type: str, key_type: str, split: str,
            metric: str, k) -> Optional[List[float]]:
    try:
        node = acc_dict[query_type][key_type][split][metric]
        node = node[k] if k in node else node[str(k)]
        return [node[lvl] for lvl in LEVELS]
    except KeyError:
        return None


def plot_multi_experiment_comparison(
    experiments: Dict[str, Dict],
    output_dir: str,
    query_type: str = "encoded_image_feature",
    key_type: str = "encoded_image_feature",
    k=1,
    metrics: Sequence[str] = ("micro_acc", "macro_acc"),
    splits: Sequence[str] = ("seen", "unseen", "harmonic_mean"),
) -> List[str]:
    """experiments: {name: acc_dict}.  One figure per (metric, split) with a
    line per experiment over the 4 taxonomy levels (reference plot_acc)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for metric in metrics:
        for split in splits:
            fig, ax = plt.subplots(figsize=(7, 4.5))
            plotted = False
            for name, acc in experiments.items():
                ys = _series(acc, query_type, key_type, split, metric, k)
                if ys is None:
                    continue
                ax.plot(LEVELS, ys, marker="o", label=name)
                plotted = True
            if not plotted:
                plt.close(fig)
                continue
            ax.set_ylim(0, 1)
            ax.set_ylabel(f"{split} {metric} (top-{k})")
            ax.set_title(f"{query_type} → {key_type}")
            ax.legend(fontsize=8)
            fig.tight_layout()
            p = os.path.join(output_dir, f"compare_{metric}_{split}_top{k}.png")
            fig.savefig(p, dpi=150)
            plt.close(fig)
            paths.append(p)
    return paths


def plot_multi_experiment_all_in_one(
    experiments: Dict[str, Dict],
    output_path: str,
    query_type: str = "encoded_image_feature",
    key_type: str = "encoded_image_feature",
    k=1,
) -> str:
    """2×2 grid (micro/macro × seen/unseen) in one figure (reference
    comparing_multi_experiment_results_in_same_plot_all_in_one.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    for col, metric in enumerate(("micro_acc", "macro_acc")):
        for row, split in enumerate(("seen", "unseen")):
            ax = axes[row][col]
            for name, acc in experiments.items():
                ys = _series(acc, query_type, key_type, split, metric, k)
                if ys is not None:
                    ax.plot(LEVELS, ys, marker="o", label=name)
            ax.set_ylim(0, 1)
            ax.set_title(f"{split} {metric}", fontsize=10)
    axes[0][0].legend(fontsize=8)
    fig.suptitle(f"{query_type} → {key_type} (top-{k})")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def plot_line_plot_pair(
    experiments: Dict[str, Dict],
    output_path: str,
    query_type: str = "encoded_dna_feature",
    key_type: str = "encoded_dna_feature",
    k=1,
    metric: str = "macro_acc",
    title: Optional[str] = None,
) -> Optional[str]:
    """Paper-figure style single-axes plot for ONE query→key pair (reference
    scripts/result/plots/line_plot_for_multiple_experiments_{dna_to_dna,
    image_to_dna,image_to_image}.py): macro-accuracy (%) over the 4 taxonomy
    levels, one color per experiment, solid = seen / dashed = unseen, minor
    gridlines every 5%, split color/style legends.  The reference hardcodes
    its numbers inline; here they come from accuracy.json dicts."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    base_colors = ("#e15759", "#f28e2b", "#4e79a7", "#59a14f", "#b07aa1", "#76b7b2")
    fig, ax = plt.subplots(figsize=(6, 4))
    # Colors are assigned by enumeration position (cycling past 6) but the
    # legend is built from the (name, color) pairs actually drawn, so an
    # experiment missing this query→key pair can't shift later experiments'
    # legend colors off their lines.
    plotted = []  # (name, color) in draw order
    for i, (name, acc) in enumerate(experiments.items()):
        color = base_colors[i % len(base_colors)]
        drew = False
        for split, style in (("seen", "-"), ("unseen", "--")):
            ys = _series(acc, query_type, key_type, split, metric, k)
            if ys is None:
                continue
            ax.plot(range(len(LEVELS)), [y * 100 for y in ys], "o" + style,
                    color=color, linewidth=3)
            drew = True
        if drew:
            plotted.append((name, color))
    if not plotted:
        plt.close(fig)
        return None
    ax.set_xticks(range(len(LEVELS)))
    ax.set_xticklabels(LEVELS)
    ax.set_ylim(0, 100)
    ax.set_ylabel(f"{'Macro' if 'macro' in metric else 'Micro'}-accuracy (%)",
                  fontsize=14)
    short = {"encoded_image_feature": "Image", "encoded_dna_feature": "DNA",
             "encoded_language_feature": "Text"}
    ax.set_title(title or f"{short.get(query_type, query_type)} to "
                          f"{short.get(key_type, key_type)}", fontsize=16)
    for y in range(0, 101, 5):
        ax.axhline(y=y, color="grey", linewidth=0.4 if y % 10 == 0 else 0.2)
    color_handles = [plt.Line2D([], [], color=c, linewidth=3, label=n)
                     for n, c in plotted]
    style_handles = [plt.Line2D([], [], color="black", linestyle=s, linewidth=3, label=lab)
                     for s, lab in (("-", "Seen"), ("--", "Unseen"))]
    first = ax.legend(handles=color_handles, loc="lower left", fontsize=8)
    ax.add_artist(first)
    ax.legend(handles=style_handles, loc="lower left", bbox_to_anchor=(0.51, 0), fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


LINE_PLOT_PAIRS = (
    ("encoded_dna_feature", "encoded_dna_feature"),
    ("encoded_image_feature", "encoded_dna_feature"),
    ("encoded_image_feature", "encoded_image_feature"),
)


def load_experiment_acc_dicts(paths: Dict[str, str]) -> Dict[str, Dict]:
    """{name: accuracy.json path} → {name: acc_dict}."""
    out = {}
    for name, p in paths.items():
        with open(p) as f:
            out[name] = json.load(f)
    return out


def plot_poster_accuracy(
    acc_dict: Dict,
    output_path: str,
    experiment_name: str = "",
    acc_type: str = "macro_acc",
    k=1,
    combos: Sequence[tuple] = (
        ("encoded_image_feature", "encoded_image_feature"),
        ("encoded_dna_feature", "encoded_dna_feature"),
        ("encoded_image_feature", "encoded_dna_feature"),
    ),
    splits: Sequence[str] = ("seen", "unseen", "harmonic_mean"),
) -> str:
    """One poster-style figure for ONE experiment: accuracy (%) over the 4
    taxonomy levels, one color per query→key combo, one marker per
    seen/unseen/harmonic split (reference scripts/result/
    plot_for_5m_poster.py:52-96 — whose own plotting loop is dead code via an
    early return; this is the figure it intended)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    acc = add_harmonic_mean_acc(acc_dict)
    colors = ("#4e79a7", "#f28e2b", "#59a14f", "#e15759", "#b07aa1")
    markers = {"seen": "o", "unseen": "^", "harmonic_mean": "s"}
    fig, ax = plt.subplots(figsize=(5.5, 4))
    for (q, key), color in zip(combos, colors):
        for split in splits:
            ys = _series(acc, q, key, split, acc_type, k)
            if ys is None:
                continue
            ax.plot(LEVELS, [y * 100 for y in ys], color=color,
                    marker=markers.get(split, "o"), linewidth=1.4, markersize=4)
    # two legends like the reference: colors = combos, markers = splits
    short = {"encoded_image_feature": "image", "encoded_dna_feature": "DNA",
             "encoded_language_feature": "text", "averaged_feature": "avg",
             "concatenated_feature": "concat", "all_key_features": "all"}
    color_handles = [plt.Line2D([], [], color=c, label=f"{short.get(q, q)}→{short.get(kk, kk)}")
                     for (q, kk), c in zip(combos, colors)]
    marker_handles = [plt.Line2D([], [], color="gray", marker=m, linestyle="",
                                 label=s.replace("_", " "))
                      for s, m in markers.items() if s in splits]
    first = ax.legend(handles=color_handles, loc="lower left", fontsize=8)
    ax.add_artist(first)
    ax.legend(handles=marker_handles, loc="lower left",
              bbox_to_anchor=(0.42, 0), fontsize=8)
    if experiment_name:
        ax.set_title(experiment_name, fontsize=12)
    ax.set_ylabel(f"{'Macro' if 'macro' in acc_type else 'Micro'}-accuracy (%)")
    ax.set_ylim(0, 100)
    ax.set_xticks(range(len(LEVELS)))
    ax.set_xticklabels(LEVELS, rotation=45)
    ax.grid(True, axis="y", alpha=0.5)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path
