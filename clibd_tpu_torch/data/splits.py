# A copy of clibd_tpu/data/splits.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""BIOSCAN split creation (reference dataset/create_splits.py:1-211).

Partition logic: drop unlabeled species → tail (<10 records) handled
separately → common species split 0.8/0.2 into seen/unseen species → seen
samples per-species 0.7/0.1/0.1/0.1 into train/val/test/query(key) →
unseen species halved into val/test, each halved per-species into keys/query
→ tail species (2..9 records) merged into the unseen splits → singletons go
to pretrain.  Overlap assertions reproduce the reference's validation.
"""

from __future__ import annotations

import os
from decimal import Decimal
from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

TAIL_THRESHOLD = 10


def filter_no_species(metadata: pd.DataFrame) -> pd.DataFrame:
    return metadata[metadata["species"] != "not_classified"]


def get_tail_species(metadata: pd.DataFrame, threshold: int = TAIL_THRESHOLD):
    counts = metadata.groupby("species").size()
    return counts.index[counts < threshold]


def create_split_boundaries(size: int, split_ratios: Sequence[float]) -> List[int]:
    assert sum(split_ratios) == 1
    sizes = [int(r * size) for r in split_ratios]
    boundaries: List[int] = []
    for s in sizes[:-1]:
        boundaries.append(s if not boundaries else s + boundaries[-1])
    return boundaries


def split_species(metadata: pd.DataFrame, split_ratios, seed=None) -> List[pd.DataFrame]:
    """Split by whole species (each species entirely in one part)."""
    if isinstance(split_ratios, float):
        split_ratios = [split_ratios, 1 - split_ratios]
    assert sum(split_ratios) == 1
    all_species = pd.unique(metadata["species"])
    rand = np.random.default_rng(seed=seed)
    boundaries = create_split_boundaries(len(all_species), split_ratios)
    parts = np.split(rand.permutation(all_species), boundaries)
    return [metadata[metadata["species"].isin(p)] for p in parts]


def split_samples_per_species(metadata: pd.DataFrame, split_ratios, seed=None) -> List[pd.DataFrame]:
    """Split each species' samples by the given ratios."""
    if isinstance(split_ratios, float):
        split_ratios = [split_ratios, 1 - split_ratios]
    ratios = [Decimal(str(f)) for f in split_ratios]
    assert sum(ratios) == 1
    metadata = metadata.reset_index()
    rand = np.random.default_rng(seed=seed)
    assignments: List[List[np.ndarray]] = [[] for _ in ratios]
    for species in pd.unique(metadata["species"]):
        idx = metadata[metadata["species"] == species].index.to_numpy()
        boundaries = create_split_boundaries(idx.shape[0], ratios)
        for part_i, part in enumerate(np.split(rand.permutation(idx), boundaries)):
            assignments[part_i].append(part)
    return [
        metadata.loc[np.concatenate(parts) if parts else []].set_index("index")
        for parts in assignments
    ]


def assert_no_overlap(source: np.ndarray, targets: List[np.ndarray], assume_unique=True) -> None:
    for target in targets:
        if len(np.intersect1d(source, target, assume_unique=assume_unique)) > 0:
            raise ValueError("Found overlap in splits.")


def create_splits(
    metadata: pd.DataFrame,
    min_species_size: int = TAIL_THRESHOLD,
    seen_ratio: float = 0.8,
    seen_splits: Sequence[float] = (0.7, 0.1, 0.1, 0.1),
    unseen_ratio: float = 0.5,
    seed: Optional[int] = None,
) -> pd.DataFrame:
    """→ split assignment frame with columns sampleid/uri/image_file/species/split."""
    species_metadata = filter_no_species(metadata)

    tail_species = get_tail_species(species_metadata, threshold=min_species_size)
    tail_metadata = species_metadata[species_metadata["species"].isin(tail_species)]
    common = species_metadata[~species_metadata["species"].isin(tail_species)]

    seen_species, unseen_species = split_species(common, seen_ratio, seed=seed)
    train_seen, val_seen, test_seen, seen_query = split_samples_per_species(
        seen_species, list(seen_splits), seed=seed
    )

    val_unseen, test_unseen = split_species(unseen_species, unseen_ratio, seed=seed)
    val_unseen, val_unseen_query = split_samples_per_species(val_unseen, unseen_ratio, seed=seed)
    test_unseen, test_unseen_query = split_samples_per_species(test_unseen, unseen_ratio, seed=seed)

    singles = get_tail_species(tail_metadata, threshold=2)
    single_species = tail_metadata[tail_metadata["species"].isin(singles)]
    tail_metadata = tail_metadata[~tail_metadata["species"].isin(singles)]
    tail_val, tail_test = split_species(tail_metadata, 0.5, seed=seed)
    tail_val, tail_val_q = split_samples_per_species(tail_val, 0.5, seed=seed)
    tail_test, tail_test_q = split_samples_per_species(tail_test, 0.5, seed=seed)
    val_unseen = pd.concat([val_unseen, tail_val])
    val_unseen_query = pd.concat([val_unseen_query, tail_val_q])
    test_unseen = pd.concat([test_unseen, tail_test])
    test_unseen_query = pd.concat([test_unseen_query, tail_test_q])

    # validation (reference :137-148)
    assert_no_overlap(
        pd.unique(val_unseen["species"]),
        [pd.unique(s["species"]) for s in (train_seen, val_seen, test_seen, test_unseen)],
    )
    assert_no_overlap(
        pd.unique(test_unseen["species"]),
        [pd.unique(s["species"]) for s in (train_seen, val_seen, test_seen)],
    )
    assert_no_overlap(train_seen["sampleid"], [val_seen["sampleid"], test_seen["sampleid"]])
    assert_no_overlap(val_seen["sampleid"], [test_seen["sampleid"]])

    cols = [c for c in ("sampleid", "uri", "image_file", "species") if c in metadata.columns]
    split_metadata = metadata[cols].copy()
    split_metadata["split"] = "no_split"
    for split_name, split in {
        "train_seen": train_seen,
        "val_seen": val_seen,
        "val_unseen": val_unseen,
        "test_seen": test_seen,
        "test_unseen": test_unseen,
        "query_seen": seen_query,
        "val_query_unseen": val_unseen_query,
        "test_query_unseen": test_unseen_query,
        "single_species": single_species,
    }.items():
        split_metadata.loc[split_metadata["sampleid"].isin(split["sampleid"]), "split"] = split_name
    return split_metadata


def export_split_csv(
    hdf5_path: str,
    out_csv: str,
    splits=None,
    chunk: int = 65536,
) -> int:
    """One CSV row per record across every split: image_file, sampleid,
    barcode, dna_bin, 4 taxon levels, split (reference scripts/
    data_processing/generate_split_csv_from_the_hdf5.py:1-82).

    Columnar + chunked instead of the reference's per-record loop (whose
    `file_name_list.index(file_name)` lookup is O(n²) over the 1M-record
    no_split group); missing columns (e.g. dna_bin in minimal builds) are
    emitted empty.  → number of rows written."""
    import csv

    import h5py

    from .hdf5 import list_splits

    if splits is None:
        splits = list_splits(hdf5_path)
    cols = ("image_file", "sampleid", "barcode", "dna_bin",
            "order", "family", "genus", "species")
    n_rows = 0
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with h5py.File(hdf5_path, "r") as f, open(out_csv, "w", newline="") as out:
        w = csv.writer(out)
        w.writerow(list(cols) + ["split"])
        for split in splits:
            g = f[split]
            n = len(g["barcode"]) if "barcode" in g else len(g[next(iter(g))])
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                data = {}
                for c in cols:
                    if c in g:
                        data[c] = [v.decode() if isinstance(v, bytes) else str(v)
                                   for v in g[c][lo:hi]]
                    else:
                        data[c] = [""] * (hi - lo)
                for i in range(hi - lo):
                    w.writerow([data[c][i] for c in cols] + [split])
                n_rows += hi - lo
    return n_rows
