# A copy of clibd_tpu/data/bins.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""DNA-BIN training labels (reference `bin_for_positive_and_negative_pairs`,
util/dataset.py:78-97,155-163): when enabled, contrastive positives are
samples sharing a BIN URI (from the BIOSCAN TSV) instead of row-index
instance discrimination."""

from __future__ import annotations

from typing import List, Sequence

import h5py
import numpy as np


def get_bin_uris_for_split(split: str, hdf5_path: str, tsv_path: str) -> List[str]:
    """Reference get_bin_from_tsv (dataset.py:78-86): look up each split
    sample's BIN `uri` in the TSV by sampleid."""
    import pandas as pd

    with h5py.File(hdf5_path, "r") as f:
        sample_ids = [s.decode("utf-8") for s in f[split]["sampleid"][:]]
    df = pd.read_csv(tsv_path, sep="\t")
    uri_of = dict(zip(df["sampleid"], df["uri"]))
    return [uri_of[s] for s in sample_ids]


def uris_to_label_ids(uris: Sequence[str]) -> np.ndarray:
    """Reference convert_uri_to_index_list (dataset.py:89-97): first-occurrence
    order integerization."""
    mapping: dict = {}
    out = np.empty(len(uris), dtype=np.int64)
    for i, u in enumerate(uris):
        if u not in mapping:
            mapping[u] = len(mapping)
        out[i] = mapping[u]
    return out


def bin_labels_for_split(split: str, hdf5_path: str, tsv_path: str) -> np.ndarray:
    return uris_to_label_ids(get_bin_uris_for_split(split, hdf5_path, tsv_path))
