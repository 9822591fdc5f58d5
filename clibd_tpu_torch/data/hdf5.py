# A copy of clibd_tpu/data/hdf5.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""BIOSCAN HDF5 split reader (schema from reference DATA.md:19-89).

Each split group holds: `image` (padded JPEG bytes [N, max_len]) +
`image_mask` (byte lengths), `barcode`, taxon levels order/family/genus/
species, `sampleid`/`processid`/`image_file`, pre-tokenized
`language_tokens_{input_ids,token_type_ids,attention_mask}`, and optionally
pre-extracted `image_features`/`dna_features`.

Unlike the reference's lazy per-worker h5py opens + per-item reads
(util/dataset.py:239-249), this reader does *bulk slab reads* per batch
(h5py → C HDF5 → numpy, no Python-per-item loop) which is what the 1-CPU
host needs to keep a TPU fed.

h5py is imported where a file is opened, not at import: the machine with the
card has no h5py, and the port's trainer imports the pipeline there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

LEVELS = ("order", "family", "genus", "species")


def split_lengths(path: str) -> Dict[str, int]:
    """Reference get_len_dict (dataset.py:370-387)."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for split in f.keys():
            g = f[split]
            if "image" in g:
                out[split] = len(g["image"])
            elif "image_features" in g:
                out[split] = len(g["image_features"])
            elif "barcode" in g:
                out[split] = len(g["barcode"])
    return out


def list_splits(path: str) -> List[str]:
    import h5py

    with h5py.File(path, "r") as f:
        return list(f.keys())


class BioscanSplit:
    """Random-access view over one split group."""

    def __init__(self, path: str, split: str):
        self.path = path
        self.split = split
        self._file: Optional[h5py.File] = None

    @property
    def group(self) -> h5py.Group:
        if self._file is None:
            import h5py

            self._file = h5py.File(self.path, "r", libver="latest")
        return self._file[self.split]

    def __len__(self) -> int:
        g = self.group
        for key in ("image", "image_features", "barcode"):
            if key in g:
                return len(g[key])
        raise KeyError(f"split {self.split} has no known datasets")

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    # -- bulk readers ------------------------------------------------------

    def _sorted_read(self, dataset, indices: np.ndarray):
        """Bulk read at arbitrary indices. Contiguous ranges (the sequential
        eval case) become single slice reads; otherwise h5py point selection
        (sorted unique, duplicates re-expanded, order restored)."""
        indices = np.asarray(indices)
        if len(indices) > 0:
            start, stop = int(indices.min()), int(indices.max()) + 1
            if stop - start == len(indices) and np.array_equal(
                indices, np.arange(start, stop)
            ):
                return dataset[start:stop]
        order = np.argsort(indices, kind="stable")
        sorted_idx = indices[order]
        uniq, inverse = np.unique(sorted_idx, return_inverse=True)
        data = dataset[uniq.tolist()] if len(uniq) < len(dataset) else dataset[:][uniq]
        data = data[inverse]
        out = np.empty_like(data)
        out[order] = data
        return out

    def jpeg_bytes(self, indices: np.ndarray) -> List[bytes]:
        g = self.group
        enc = self._sorted_read(g["image"], indices)
        lengths = self._sorted_read(g["image_mask"], indices)
        return [enc[i, : int(lengths[i])].tobytes() for i in range(len(indices))]

    def barcodes(self, indices: np.ndarray) -> np.ndarray:
        return self._sorted_read(self.group["barcode"], indices)

    def labels(self, indices: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        g = self.group
        out = {}
        for level in LEVELS:
            data = g[level][:] if indices is None else self._sorted_read(g[level], np.asarray(indices))
            out[level] = np.array([x.decode("utf-8") for x in data], dtype=object)
        return out

    def label_dicts(self, indices: Optional[np.ndarray] = None) -> List[dict]:
        """Reference get_array_of_label_dicts (dataset.py:54-67)."""
        levels = self.labels(indices)
        n = len(levels["order"])
        return [{lv: levels[lv][i] for lv in LEVELS} for i in range(n)]

    def ids(self, indices: Optional[np.ndarray] = None, field: str = "processid") -> List[str]:
        g = self.group
        data = g[field][:] if indices is None else self._sorted_read(g[field], np.asarray(indices))
        return [x.decode("utf-8") for x in data]

    def language_tokens(self, indices: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        g = self.group
        out = {}
        for name, key in (
            ("input_ids", "language_tokens_input_ids"),
            ("token_type_ids", "language_tokens_token_type_ids"),
            ("attention_mask", "language_tokens_attention_mask"),
        ):
            data = g[key][:] if indices is None else self._sorted_read(g[key], np.asarray(indices))
            out[name] = np.asarray(data, dtype=np.int32)
        return out

    def features(self, name: str, indices: Optional[np.ndarray] = None) -> np.ndarray:
        g = self.group
        data = g[name][:] if indices is None else self._sorted_read(g[name], np.asarray(indices))
        return np.asarray(data, dtype=np.float32)

    def taxonomy_strings(self, indices: Optional[np.ndarray] = None) -> List[str]:
        """'order family genus species' per sample (dataset.py:152-155)."""
        levels = self.labels(indices)
        n = len(levels["order"])
        return [
            f"{levels['order'][i]} {levels['family'][i]} {levels['genus'][i]} {levels['species'][i]}"
            for i in range(n)
        ]
