# A copy of clibd_tpu/data/insect.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""INSECT dataset (Fine-Grained-ZSL-with-DNA): reader + loaders
(reference bioscanclip/util/dataset.py:950-1171 INSECTDataset).

Reads BZSL's att_splits.mat (split index vectors, 1-based) and res101.mat
(ids/nucleotides/species), images from a per-id HDF5 ('images/<id>' JPEG
bytes), and the species→{order,family,genus} map from JSON (missing levels
become 'not_classified', dataset.py:912-947).  Text input is
"order family genus species"; labels are taxon dicts (eval) or row indices
(contrastive training).

h5py and scipy.io are imported where a file is opened, not at import: the
machine with the card has no h5py, and the port's trainer imports the
loaders there.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional

import numpy as np

from .pipeline import Batch, BatchSpec, shard_indices
from .tokenizers import WordPieceTokenizer, tokenize_dna_batch
from .transforms import eval_transform, train_transform


def species_list_to_input_strings(species_list: List[str], species_to_others: Dict) -> List[str]:
    levels = ("order", "family", "genus")
    out = []
    for species in species_list:
        info = species_to_others.get(species, {})
        parts = [info.get(level, "not_classified") for level in levels]
        out.append(" ".join(parts) + " " + species)
    return out


def species_list_to_label_dicts(species_list: List[str], species_to_others: Dict) -> List[dict]:
    out = []
    for species in species_list:
        info = species_to_others.get(species, {})
        out.append(
            {
                "order": info.get("order", "not_classified"),
                "family": info.get("family", "not_classified"),
                "genus": info.get("genus", "not_classified"),
                "species": species,
            }
        )
    return out


class INSECTDataset:
    """Split view over the INSECT .mat + image-HDF5 files."""

    SPLITS = ("trainval_loc", "train_loc", "val_loc", "test_seen_loc", "test_unseen_loc", "all")

    def __init__(
        self,
        path_to_att_splits_mat: str,
        path_to_res_101_mat: str,
        image_hdf5_path: str,
        species_to_others: Dict | str,
        split: str = "all",
        tokenizer: Optional[WordPieceTokenizer] = None,
        text_max_len: int = 20,
        language_tokens: Optional[dict] = None,
    ):
        import scipy.io as sio

        if isinstance(species_to_others, str):
            with open(species_to_others) as f:
                species_to_others = json.load(f)
        att = sio.loadmat(path_to_att_splits_mat)
        res = sio.loadmat(path_to_res_101_mat)
        image_ids = [x.item() for x in res["ids"].flatten()]
        barcodes = [x.item() for x in res["nucleotides"].flatten()]
        species = [x.item() for x in res["species"].flatten()]
        if split != "all":
            # BZSL att_splits.mat stores loc vectors as (N,1) column OR (1,N)
            # row MATLAB arrays depending on how they were written — ravel()
            # is orientation-proof ([0] on a column vector would silently
            # yield a 1-sample split)
            loc = np.asarray(att[split]).ravel()
            image_ids = [image_ids[i - 1] for i in loc]
            barcodes = [barcodes[i - 1] for i in loc]
            species = [species[i - 1] for i in loc]
        self.image_ids = image_ids
        self.barcodes = barcodes
        self.species = species
        self.species_to_others = species_to_others
        self.image_hdf5_path = image_hdf5_path
        self._images = None  # the image HDF5, opened at the first read

        self.text_strings = species_list_to_input_strings(species, species_to_others)
        if language_tokens is not None:
            self.language_tokens = language_tokens
        elif tokenizer is not None:
            self.language_tokens = tokenizer.encode_batch(self.text_strings, max_length=text_max_len)
        else:
            self.language_tokens = None

    def __len__(self) -> int:
        return len(self.image_ids)

    def label_dicts(self) -> List[dict]:
        return species_list_to_label_dicts(self.species, self.species_to_others)

    def jpeg_bytes(self, idx: int) -> bytes:
        if self._images is None:
            import h5py

            self._images = h5py.File(self.image_hdf5_path, "r")
        return bytes(self._images["images"][self.image_ids[idx]][:])

    def close(self):
        if self._images is not None:
            self._images.close()
            self._images = None


class INSECTLoader:
    """Batch iterator with the same Batch layout as BioscanLoader."""

    def __init__(
        self,
        dataset: INSECTDataset,
        spec: BatchSpec,
        labels: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        self.ds = dataset
        self.spec = spec
        self.seed = seed
        n = len(dataset)
        self.labels = labels if labels is not None else np.arange(n, dtype=np.int64)
        self.dna_tokens = tokenize_dna_batch(
            dataset.barcodes, k=spec.dna_kmer, max_bp=spec.dna_max_bp
        )

    def __len__(self):
        n = len(self.ds)
        if self.spec.train:
            return n // self.spec.batch_size
        return -(-n // self.spec.batch_size)

    def batches(self, epoch: int = 0, shuffle: Optional[bool] = None,
                start_batch: int = 0) -> Iterator[Batch]:
        """start_batch: skip the first N batches of this epoch's deterministic
        stream (mid-epoch resume, same contract as BioscanLoader.batches)."""
        spec = self.spec
        shuffle = spec.train if shuffle is None else shuffle
        idx = shard_indices(
            len(self.ds), epoch, 0, 1, spec.batch_size,
            shuffle=shuffle, drop_last=spec.train, seed=self.seed,
        )
        nb = len(self)
        for b in range(start_batch, nb):
            lo = b * spec.batch_size
            sel = idx[lo : lo + spec.batch_size]
            if len(sel) == 0:
                break
            batch = Batch()
            batch["index"] = sel.astype(np.int64)
            batch["label"] = self.labels[sel]
            if spec.with_image:
                imgs = []
                for j, i in enumerate(sel):
                    data = self.ds.jpeg_bytes(int(i))
                    if spec.train:
                        r = np.random.default_rng((self.seed, epoch, b, j))
                        imgs.append(train_transform(r, data, spec.image_size, spec.resize_to))
                    else:
                        imgs.append(eval_transform(data, spec.image_size, spec.resize_to))
                batch["image"] = np.stack(imgs).astype(np.float32)
            if spec.with_dna:
                batch["dna"] = self.dna_tokens[sel]
            if spec.with_language and self.ds.language_tokens is not None:
                batch["language"] = {k: v[sel] for k, v in self.ds.language_tokens.items()}
            yield batch

    def label_dicts(self) -> List[dict]:
        return self.ds.label_dicts()

    def ids(self, field: str = "processid") -> List[str]:
        return [str(i) for i in self.ds.image_ids]

    def close(self):
        self.ds.close()


# ---------------------------------------------------------------------------
# BZSL CSV export (reference scripts/BZSL/extract_feature_for_insect_dataset.py:
# 72-102): DNA embeddings averaged per class → [D, num_classes] CSV;
# image embeddings transposed → [D, N] CSV.
# ---------------------------------------------------------------------------


def export_bzsl_csvs(
    dna_features: np.ndarray,
    image_features: np.ndarray,
    class_labels: np.ndarray,
    dna_csv_path: str,
    image_csv_path: str,
) -> None:
    """class_labels: 0-based integer class per sample (reference uses
    res101 'labels' − 1)."""
    all_classes = np.unique(class_labels)
    all_classes.sort()
    class_embed = np.stack(
        [dna_features[class_labels == c].mean(axis=0) for c in all_classes]
    )
    np.savetxt(dna_csv_path, class_embed.T, delimiter=",")
    np.savetxt(image_csv_path, image_features.astype(np.float32).T, delimiter=",")
