# A copy of clibd_tpu/analysis/tables.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Result tables (reference scripts/result/generate_latex_table.py 286 LoC +
scripts/flattenCsv.py 76 LoC): LaTeX accuracy tables with seen/unseen
harmonic mean, and results.csv flattening."""

from __future__ import annotations

import csv
from typing import Dict, List, Sequence

from ..utils.metrics import LEVELS, harmonic_mean


def results_csv_rows(path: str) -> List[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def flatten_results_csv(input_path: str, output_path: str) -> str:
    """scripts/flattenCsv.py: one wide row per (Query, Key) with the metric
    values laid out in columns."""
    rows = results_csv_rows(input_path)
    by_combo: Dict[tuple, dict] = {}
    value_cols = [
        "Seen_Order", "Seen_Family", "Seen_Genus", "Seen_Species",
        "Unseen_Order", "Unseen_Family", "Unseen_Genus", "Unseen_Species",
    ]
    for row in rows:
        combo = (row["Query"], row["Key"])
        entry = by_combo.setdefault(combo, {"Query": row["Query"], "Key": row["Key"]})
        metric = row["Metric"]
        for col in value_cols:
            entry[f"{metric}_{col}"] = row[col]
    if not by_combo:
        raise ValueError(f"No rows in {input_path}")
    header = sorted({k for e in by_combo.values() for k in e}, key=lambda k: (k not in ("Query", "Key"), k))
    with open(output_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=header)
        writer.writeheader()
        for entry in by_combo.values():
            writer.writerow(entry)
    return output_path


def latex_accuracy_table(
    acc_dict: Dict,
    query_type: str = "encoded_image_feature",
    key_type: str = "encoded_image_feature",
    k: int = 1,
    caption: str = "Taxonomic retrieval accuracy",
    label: str = "tab:accuracy",
    macro: bool = False,
) -> str:
    """LaTeX table: per level, seen / unseen / harmonic-mean accuracy."""
    acc_type = "macro_acc" if macro else "micro_acc"
    entry = acc_dict[query_type][key_type]
    lines = [
        "\\begin{table}[tb]",
        "\\centering",
        f"\\caption{{{caption}}}",
        f"\\label{{{label}}}",
        "\\begin{tabular}{lccc}",
        "\\toprule",
        "Level & Seen & Unseen & H.M. \\\\",
        "\\midrule",
    ]
    for level in LEVELS:
        # k keys are ints in fresh acc_dicts but strings after a JSON
        # round-trip (accuracy.json / acc_dict_*.json)
        seen_k = entry["seen"][acc_type]
        unseen_k = entry["unseen"][acc_type]
        seen = seen_k.get(k, seen_k.get(str(k)))[level]
        unseen = unseen_k.get(k, unseen_k.get(str(k)))[level]
        hm = harmonic_mean(seen, unseen)
        lines.append(
            f"{level.capitalize()} & {100*seen:.1f} & {100*unseen:.1f} & {100*hm:.1f} \\\\"
        )
    lines += ["\\bottomrule", "\\end{tabular}", "\\end{table}"]
    return "\n".join(lines)


def summarize_per_class_acc(per_class_acc: Dict, k: int = 1, level: str = "species") -> Dict:
    """Per-class accuracy digest (reference logs/check_per_class_acc.py +
    scripts/result per-class analysis): for each query/key combo, the count
    of perfect / failed classes and the worst performers."""
    out: Dict = {}
    for q, by_key in per_class_acc.items():
        for kt, entry in by_key.items():
            for split in ("seen", "unseen"):
                table = entry.get(split, {}).get(k, {}).get(level) or entry.get(split, {}).get(str(k), {}).get(level)
                if not table:
                    continue
                values = sorted(table.items(), key=lambda kv: kv[1])
                accs = [v for _, v in values]
                out[f"{q}||{kt}||{split}"] = {
                    "num_classes": len(accs),
                    "mean": sum(accs) / len(accs),
                    "perfect_classes": sum(1 for a in accs if a == 1.0),
                    "zero_classes": sum(1 for a in accs if a == 0.0),
                    "worst": values[:10],
                }
    return out


def dataset_statistics(label_dicts: List[dict]) -> Dict:
    """Per-level class counts + long-tail stats (reference
    scripts/create_statistics_summaries.py core numbers)."""
    import numpy as np

    stats: Dict = {"num_samples": len(label_dicts)}
    for level in LEVELS:
        values = [l[level] for l in label_dicts]
        uniq, counts = np.unique(values, return_counts=True)
        stats[level] = {
            "num_classes": int(len(uniq)),
            "max_class_size": int(counts.max()) if len(counts) else 0,
            "min_class_size": int(counts.min()) if len(counts) else 0,
            "median_class_size": float(np.median(counts)) if len(counts) else 0,
            "classes_under_10": int((counts < 10).sum()),
        }
    return stats
