# A copy of clibd_tpu/data/subset.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""HDF5 subsetting (reference scripts/data_processing/
create_special_pre_train_for_bioscan_5m[_multi_processing].py): build a
smaller split HDF5 whose pretrain group is a random subset, keeping the
other splits intact — the `train_with_small_subset` input."""

from __future__ import annotations

from typing import Dict

import h5py
import numpy as np


def subset_hdf5(
    src_path: str,
    dst_path: str,
    subset_sizes: Dict[str, int],
    seed: int = 42,
) -> str:
    """Copy src to dst; for splits named in subset_sizes, keep a random
    subset of that many records (all per-record datasets sliced together)."""
    rng = np.random.default_rng(seed)
    with h5py.File(src_path, "r") as src, h5py.File(dst_path, "w") as dst:
        for split in src.keys():
            sg = src[split]
            dg = dst.create_group(split)
            n = None
            for key in sg.keys():
                n = len(sg[key])
                break
            if split in subset_sizes and n is not None and subset_sizes[split] < n:
                keep = np.sort(rng.choice(n, size=subset_sizes[split], replace=False))
            else:
                keep = None
            for key in sg.keys():
                data = sg[key][:]
                if keep is not None and len(data) == n:
                    data = data[keep]
                dg.create_dataset(key, data=data)
    return dst_path


def stratified_subset_indices(
    species: np.ndarray,
    ratio: float,
    seed: int = 42,
) -> np.ndarray:
    """Per-species stratified sample at `ratio`, keeping AT LEAST ONE record
    per species — reference create_special_pre_train_for_bioscan_5m.py:16-67
    (special_round_to_avoid_zero: round(n*ratio) floored at 1; its
    "not_classified" bucket is just one more string group here).

    → sorted int64 indices into `species`."""
    rng = np.random.default_rng(seed)
    species = np.asarray([s.decode() if isinstance(s, bytes) else str(s)
                          for s in species])
    keep = []
    # group indices per species (the unlabeled bucket is one group)
    order = np.argsort(species, kind="stable")
    sorted_sp = species[order]
    boundaries = np.flatnonzero(
        np.concatenate(([True], sorted_sp[1:] != sorted_sp[:-1])))
    for b, e in zip(boundaries, np.concatenate((boundaries[1:], [len(order)]))):
        idx = order[b:e]
        k = max(1, int(round(len(idx) * ratio)))
        keep.append(rng.choice(idx, size=min(k, len(idx)), replace=False))
    return np.sort(np.concatenate(keep)).astype(np.int64)


def subset_hdf5_stratified(
    src_path: str,
    dst_path: str,
    split: str = "no_split_and_seen_train",
    ratio: float = 0.2,
    seed: int = 42,
    copy_other_splits: bool = True,
    chunk: int = 65536,
) -> int:
    """The reference's "special 1/5 pre-train" subset for BIOSCAN-5M: the
    pretrain split stratified per species at `ratio` (>=1 record per
    species); other splits copied verbatim (or omitted).  Columns are copied
    in chunked slabs, not the reference's per-record Python loop (hours at
    5M scale).  → number of kept records."""
    with h5py.File(src_path, "r") as src, h5py.File(dst_path, "w") as dst:
        keep = stratified_subset_indices(src[split]["species"][:], ratio, seed)
        n_keep = len(keep)
        for name in src.keys():
            if name != split:
                if copy_other_splits:
                    # verbatim group copy, streamed by h5py (no full-column
                    # host materialization)
                    src.copy(src[name], dst, name=name)
                continue
            sg = src[name]
            dg = dst.create_group(name)
            for key in sg.keys():
                ds = sg[key]
                if len(ds) != len(src[split]["species"]):
                    dg.create_dataset(key, data=ds[:])  # non-record metadata
                    continue
                # h5py fancy indexing needs sorted unique indices — keep is
                # sorted; stream slab-by-slab into a pre-created destination
                # dataset so memory stays O(chunk), not O(kept column)
                out = dg.create_dataset(key, shape=(n_keep, *ds.shape[1:]),
                                        dtype=ds.dtype)
                for lo in range(0, n_keep, chunk):
                    sel = keep[lo:lo + chunk].tolist()
                    out[lo:lo + len(sel)] = ds[sel]
    return int(n_keep)
