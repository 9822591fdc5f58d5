# A copy of the repository's tests/fixtures.py (make_tiny_bioscan_hdf5 and its draws): the
# harnesses keep their own copy so that they import nothing of the JAX package's tests.
"""Synthetic BIOSCAN-style HDF5 files in the reference DATA.md schema: per-split
groups each holding `image` (padded JPEG bytes) + `image_mask` (byte
lengths), `barcode`, 4 taxon levels, `sampleid`/`processid`/`image_file`,
and pre-tokenized `language_tokens_*`.  h5py is imported where a file is
written."""

from __future__ import annotations

import io

import numpy as np

SPLITS = (
    "no_split_and_seen_train",
    "train_seen",
    "val_seen",
    "val_unseen",
    "test_seen",
    "test_unseen",
    "seen_keys",
    "unseen_keys",
    "all_keys",
)

ORDERS = ["Diptera", "Hymenoptera"]
FAMILIES = ["Sciaridae", "Cecidomyiidae", "Braconidae"]
GENERA = ["Corynoptera", "Bradysia", "Aphidius"]
SPECIES = [f"species_{i}" for i in range(8)]


def random_jpeg_bytes(rng: np.random.Generator, h: int = 64, w: int = 80) -> bytes:
    from PIL import Image

    arr = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=85)
    return buf.getvalue()


def random_barcode(rng: np.random.Generator, length: int = 658) -> str:
    return "".join(rng.choice(list("ACGT"), size=length))


def make_tiny_bioscan_hdf5(
    path: str,
    n_per_split: int = 12,
    seed: int = 0,
    splits=SPLITS,
    text_max_len: int = 20,
    image_hw=None,  # (h, w) fixed size; None = random 48-96 per image
) -> str:
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        for split in splits:
            g = f.create_group(split)
            if image_hw is not None:
                jpegs = [random_jpeg_bytes(rng, h=image_hw[0], w=image_hw[1])
                         for _ in range(n_per_split)]
            else:
                jpegs = [random_jpeg_bytes(rng, h=int(rng.integers(48, 96)),
                                           w=int(rng.integers(48, 96)))
                         for _ in range(n_per_split)]
            max_len = max(len(j) for j in jpegs)
            img = np.zeros((n_per_split, max_len), dtype=np.uint8)
            mask = np.zeros(n_per_split, dtype=np.int64)
            for i, j in enumerate(jpegs):
                img[i, : len(j)] = np.frombuffer(j, dtype=np.uint8)
                mask[i] = len(j)
            g.create_dataset("image", data=img)
            g.create_dataset("image_mask", data=mask)

            barcodes = [random_barcode(rng, int(rng.integers(200, 660))) for _ in range(n_per_split)]
            g.create_dataset("barcode", data=np.array([b.encode() for b in barcodes]))

            def cat(values):
                return np.array([rng.choice(values).encode() for _ in range(n_per_split)])

            g.create_dataset("order", data=cat(ORDERS))
            g.create_dataset("family", data=cat(FAMILIES))
            g.create_dataset("genus", data=cat(GENERA))
            g.create_dataset("species", data=cat(SPECIES))
            ids = np.array([f"{split}_{i}".encode() for i in range(n_per_split)])
            g.create_dataset("sampleid", data=ids)
            g.create_dataset("processid", data=ids)
            g.create_dataset("image_file",
                             data=np.array([f"{split}_{i}.jpg".encode() for i in range(n_per_split)]))

            # pre-tokenized language tokens (random but valid-shaped)
            input_ids = rng.integers(0, 1000, size=(n_per_split, text_max_len), dtype=np.int64)
            input_ids[:, 0] = 101  # [CLS]
            att = np.ones((n_per_split, text_max_len), dtype=np.int64)
            g.create_dataset("language_tokens_input_ids", data=input_ids)
            g.create_dataset("language_tokens_token_type_ids", data=np.zeros_like(input_ids))
            g.create_dataset("language_tokens_attention_mask", data=att)
    return path
