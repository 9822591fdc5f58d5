# A copy of clibd_tpu/analysis/statistics.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Dataset statistics summaries (reference scripts/create_statistics_summaries.py,
723 LoC): per-split × per-level class/record counts, records-per-class range
histograms, seen/unseen overlap statistics, average-records-per-class tables,
with CSV and PNG outputs."""

from __future__ import annotations

import csv
import os
import sys
from collections import Counter
from typing import Dict, List, Optional, Sequence, TextIO

import numpy as np

LEVELS = ("order", "family", "genus", "species")

# the reference's records-per-class bins (create_statistics_summaries.py ranges)
DEFAULT_RANGES = ((1, 1), (2, 9), (10, 99), (100, 999), (1000, None))


def count_frequencies(label_dicts: Sequence[dict],
                      levels: Sequence[str] = LEVELS) -> Dict[str, Counter]:
    """{level: Counter(class → record count)} (reference count_frequencies)."""
    out = {lvl: Counter() for lvl in levels}
    for d in label_dicts:
        for lvl in levels:
            out[lvl][d.get(lvl, "not_classified")] += 1
    return out


def split_level_counts(hdf5_path: str, splits: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    """Per split: records + per-level unique-class counts straight from the
    HDF5 (the reference walks the TSVs; the HDF5 groups are the same data)."""
    import h5py

    out: Dict[str, Dict] = {}
    with h5py.File(hdf5_path, "r") as f:
        names = splits if splits is not None else list(f.keys())
        for split in names:
            if split not in f:
                continue
            g = f[split]
            entry = {"records": int(g["order"].shape[0])}
            for lvl in LEVELS:
                vals = [v.decode() if isinstance(v, bytes) else str(v) for v in g[lvl][...]]
                entry[f"{lvl}_classes"] = len(set(vals))
            out[split] = entry
    return out


def range_histogram(counts: Counter, ranges=DEFAULT_RANGES) -> Dict[str, int]:
    """Bin classes by records-per-class (reference expand_ranges/get_dist):
    {"1": n_singletons, "2-9": ..., "1000+": ...} counting CLASSES per bin."""
    out = {}
    for lo, hi in ranges:
        label = f"{lo}" if lo == hi else (f"{lo}+" if hi is None else f"{lo}-{hi}")
        out[label] = sum(1 for c in counts.values()
                         if c >= lo and (hi is None or c <= hi))
    return out


def overlap_statistics(seen_counts: Counter, unseen_counts: Counter) -> Dict:
    """Class overlap between seen/unseen groupings (reference
    get_overlap_statistics; the split design asserts species-level overlap
    is zero — exam_1m_splits_overlap.py)."""
    seen = set(seen_counts)
    unseen = set(unseen_counts)
    both = seen & unseen
    return {
        "seen_classes": len(seen),
        "unseen_classes": len(unseen),
        "overlap_classes": len(both),
        "overlap_fraction_of_unseen": (len(both) / len(unseen)) if unseen else 0.0,
    }


def average_records_per_class(counts: Counter) -> float:
    return (sum(counts.values()) / len(counts)) if counts else 0.0


def print_table(rows: List[Sequence], title: str, output: Optional[TextIO] = None) -> None:
    """ASCII table (reference print_table, create_statistics_summaries.py:459).
    output resolves to sys.stdout at CALL time (an import-time default would
    escape pytest's capture and any later stream redirection)."""
    if output is None:
        output = sys.stdout
    if not rows:
        return
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(rows[0]))]
    print(title, file=output)
    for ri, row in enumerate(rows):
        line = "  ".join(str(v).ljust(w) for v, w in zip(row, widths))
        print(line, file=output)
        if ri == 0:
            print("-" * len(line), file=output)


def write_statistics_csvs(hdf5_path: str, output_dir: str,
                          splits: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """The full summary: split_level_counts.csv, per-level range histograms,
    seen/unseen species overlap, averages.  Returns {name: path}."""
    import h5py

    os.makedirs(output_dir, exist_ok=True)
    paths: Dict[str, str] = {}

    counts_by_split = split_level_counts(hdf5_path, splits)
    p = os.path.join(output_dir, "split_level_counts.csv")
    with open(p, "w", newline="") as f:
        cols = ["split", "records"] + [f"{l}_classes" for l in LEVELS]
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for split, entry in sorted(counts_by_split.items()):
            w.writerow({"split": split, **entry})
    paths["split_level_counts"] = p

    with h5py.File(hdf5_path, "r") as f:
        freq_by_split = {}
        for split in counts_by_split:
            g = f[split]
            dicts = [
                {lvl: (v.decode() if isinstance(v, bytes) else str(v))
                 for lvl, v in zip(LEVELS, vals)}
                for vals in zip(*(g[lvl][...] for lvl in LEVELS))
            ]
            freq_by_split[split] = count_frequencies(dicts)

    p = os.path.join(output_dir, "records_per_class_histogram.csv")
    with open(p, "w", newline="") as f:
        w = csv.writer(f)
        header_bins = list(range_histogram(Counter({"x": 1})).keys())
        w.writerow(["split", "level", "avg_records_per_class"] + header_bins)
        for split, freqs in sorted(freq_by_split.items()):
            for lvl in LEVELS:
                hist = range_histogram(freqs[lvl])
                w.writerow([split, lvl, round(average_records_per_class(freqs[lvl]), 2)]
                           + [hist[b] for b in header_bins])
    paths["records_per_class_histogram"] = p

    seen_split = next((s for s in ("train_seen", "seen_keys", "all_keys") if s in freq_by_split), None)
    unseen_split = next((s for s in ("test_unseen", "val_unseen", "unseen_keys") if s in freq_by_split), None)
    if seen_split and unseen_split:
        p = os.path.join(output_dir, "seen_unseen_overlap.csv")
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["level", "seen_classes", "unseen_classes",
                        "overlap_classes", "overlap_fraction_of_unseen"])
            for lvl in LEVELS:
                st = overlap_statistics(freq_by_split[seen_split][lvl],
                                        freq_by_split[unseen_split][lvl])
                w.writerow([lvl, st["seen_classes"], st["unseen_classes"],
                            st["overlap_classes"], round(st["overlap_fraction_of_unseen"], 4)])
        paths["seen_unseen_overlap"] = p

    p = os.path.join(output_dir, "unique_barcode_bin_counts.csv")
    ub = unique_barcode_bin_counts(hdf5_path, splits=list(counts_by_split))
    with open(p, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["split", "records", "unique_barcodes", "unique_dna_bins"])
        for split, entry in sorted(ub.items()):
            w.writerow([split, entry["records"], entry["unique_barcodes"],
                        entry["unique_dna_bins"]])
    paths["unique_barcode_bin_counts"] = p

    paths["histogram_png"] = plot_records_per_class_histogram(
        freq_by_split, os.path.join(output_dir, "records_per_class_histogram.png"))

    comp = species_split_composition(hdf5_path, splits=splits)
    if comp["groups"]:
        paths["species_split_composition"] = write_species_split_composition(
            comp, os.path.join(output_dir, "species_split_composition.csv"))
        paths["species_split_png"] = plot_species_split_distribution(
            comp, os.path.join(output_dir, "species_split_distribution.png"))
    return paths


def unique_barcode_bin_counts(hdf5_path: str,
                              splits: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    """Unique barcode + DNA-BIN counts per split (reference scripts/result/
    check_unique_barcode_and_bin_number.py — which joins the 5M TSV for
    dna_bin; here the HDF5's own dna_bin column is used when present)."""
    import h5py

    from ..data.hdf5 import list_splits

    if splits is None:
        splits = list_splits(hdf5_path)
    out: Dict[str, Dict] = {}
    with h5py.File(hdf5_path, "r") as f:
        for split in splits:
            g = f[split]
            if "barcode" not in g:
                continue
            barcodes = g["barcode"][...]
            entry = {"records": int(len(barcodes)),
                     "unique_barcodes": int(len(np.unique(barcodes))),
                     "unique_dna_bins": None}
            if "dna_bin" in g:
                entry["unique_dna_bins"] = int(len(np.unique(g["dna_bin"][...])))
            out[split] = entry
    return out


# data_visualization.py's composite "species splits": record-level species
# lists concatenated across the member HDF5 groups (reference
# scripts/result/data_visualization.py:228-234).  Members absent from a file
# are skipped (the 1M file has val/test_unseen_keys; reduced fixtures may
# only carry a combined unseen_keys).
SPECIES_SPLIT_GROUPS = (
    ("seen", ("seen_keys", "train_seen", "val_seen", "test_seen")),
    ("val_unseen", ("val_unseen", "val_unseen_keys")),
    ("test_unseen", ("test_unseen", "test_unseen_keys", "unseen_keys")),
)

# records-per-species bins for the stacked species-distribution figure
# (data_visualization.py:66-67; the reference's last bin is written 161-2714
# because 2714 is the 1M max — semantically open-ended, so None here).
# Species with a single record fall outside every bin, as in the reference.
DATA_VIZ_RANGES = ((2, 10), (11, 20), (21, 40), (41, 80), (81, 160), (161, None))

SKIP_SPLITS = ("no_split_and_seen_train", "no_split", "all_keys", "single_species")


def species_split_composition(hdf5_path: str,
                              groups=SPECIES_SPLIT_GROUPS,
                              maj_threshold: int = 9,
                              skip: Sequence[str] = SKIP_SPLITS,
                              splits: Optional[Sequence[str]] = None) -> Dict:
    """Reference scripts/result/data_visualization.py:200-328 — species-split
    membership analysis on the split HDF5:

    - per composite group (seen / val_unseen / test_unseen): record count,
      unique species, each member split's share of the group's records
      (the reference's "% species in ..." printouts, which are record
      fractions), and a records-per-species range histogram
      (``DATA_VIZ_RANGES``) feeding the stacked distribution figure;
    - maj/min species (>= / < ``maj_threshold`` records over all non-skipped
      splits): what fraction of each appears in each group.

    Quirk note: the reference tallies ``all_species_count_dict`` starting at
    0 on a species' FIRST sighting (data_visualization.py:236-240), so its
    "count" is occurrences-1 and its ">= 9" is really ">= 10 records".  Here
    counts are true record counts; pass ``maj_threshold=10`` to reproduce
    the reference's effective cut.
    """
    import h5py

    group_species: Dict[str, list] = {}
    per_split_len: Dict[str, Dict[str, int]] = {}
    all_counts: Counter = Counter()
    with h5py.File(hdf5_path, "r") as f:
        for split in f.keys():
            if split in skip or "species" not in f[split]:
                continue
            if splits is not None and split not in splits:
                continue
            vals = [v.decode() if isinstance(v, bytes) else str(v)
                    for v in f[split]["species"][...]]
            all_counts.update(vals)
            for gname, members in groups:
                if split in members:
                    group_species.setdefault(gname, []).extend(vals)
                    per_split_len.setdefault(gname, {})[split] = len(vals)

    out: Dict = {"groups": {}, "maj_min": {}}
    for gname, _ in groups:
        species = group_species.get(gname, [])
        if not species:
            continue
        counts = Counter(species)
        out["groups"][gname] = {
            "records": len(species),
            "unique_species": len(counts),
            "per_split_record_fraction": {
                s: n / len(species) for s, n in sorted(per_split_len[gname].items())
            },
            "range_histogram": range_histogram(counts, ranges=DATA_VIZ_RANGES),
        }

    group_sets = {g: set(sp) for g, sp in group_species.items()}
    for kind, keep in (("maj", lambda c: c >= maj_threshold),
                       ("min", lambda c: c < maj_threshold)):
        members = [s for s, c in all_counts.items() if keep(c)]
        entry = {"total": len(members)}
        for gname in group_sets:
            inside = sum(1 for s in members if s in group_sets[gname])
            entry[gname] = inside / len(members) if members else 0.0
        out["maj_min"][kind] = entry
    return out


def write_species_split_composition(comp: Dict, output_path: str) -> str:
    """CSV form of :func:`species_split_composition` (one row per group +
    maj/min rows), replacing the reference's print-only output."""
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    bins = list(range_histogram(Counter({"x": 1}), ranges=DATA_VIZ_RANGES).keys())
    with open(output_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["row", "group", "records", "unique_species",
                    "per_split_record_fraction"] + bins)
        for gname, e in comp["groups"].items():
            fracs = ";".join(f"{s}={v:.4f}"
                             for s, v in e["per_split_record_fraction"].items())
            w.writerow(["group", gname, e["records"], e["unique_species"], fracs]
                       + [e["range_histogram"][b] for b in bins])
        for kind, e in comp["maj_min"].items():
            fracs = ";".join(f"{g}={v:.4f}" for g, v in sorted(e.items())
                             if g != "total")
            w.writerow([kind, "", e["total"], "", fracs] + [""] * len(bins))
    return output_path


def plot_species_split_distribution(comp: Dict, output_path: str) -> str:
    """Stacked horizontal bar of species counts per records-per-species bin,
    one bar per composite group (reference
    plot_species_count_in_each_species_split, data_visualization.py:57-102)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = list(comp["groups"])
    bins = list(range_histogram(Counter({"x": 1}), ranges=DATA_VIZ_RANGES).keys())
    cmap = plt.get_cmap("viridis")
    fig, ax = plt.subplots(figsize=(10, 2.5 + 0.6 * len(groups)))
    left = np.zeros(len(groups))
    for i, b in enumerate(bins):
        vals = np.array([comp["groups"][g]["range_histogram"][b] for g in groups],
                        dtype=float)
        ax.barh(groups, vals, left=left, label=b,
                color=cmap(i / max(len(bins) - 1, 1)))
        left += vals
    ax.set_xlabel("Number of species")
    ax.set_title("Distribution of species")
    ax.legend(title="records per species", fontsize=7,
              loc="upper left", bbox_to_anchor=(1.0, 1.0))
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def plot_records_per_class_histogram(freq_by_split: Dict[str, Dict[str, Counter]],
                                     output_path: str, level: str = "species") -> str:
    """Grouped bar chart of class counts per records-per-class bin (reference
    plot_count_in_splits_as_histogram)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    splits = sorted(freq_by_split)
    bins = list(range_histogram(Counter({"x": 1})).keys())
    x = np.arange(len(bins))
    width = 0.8 / max(len(splits), 1)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for i, split in enumerate(splits):
        hist = range_histogram(freq_by_split[split][level])
        ax.bar(x + i * width, [hist[b] for b in bins], width, label=split)
    ax.set_xticks(x + width * (len(splits) - 1) / 2)
    ax.set_xticklabels(bins)
    ax.set_xlabel(f"records per {level}")
    ax.set_ylabel("classes")
    ax.legend(fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path
