# A copy of clibd_tpu/data/builders.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""HDF5 dataset builders (reference scripts/data_processing/
generate_hdf5_file_5m.py and friends, ~1,200 LoC): build split HDF5 files
matching DATA.md from a metadata table + image directory.

Per split group: `image` [N, max_jpeg_len] zero-padded JPEG bytes +
`image_mask` lengths, `barcode`, 4 taxon levels, `sampleid`/`processid`/
`image_file`, and pre-tokenized `language_tokens_*` ("order family genus
species", max_len 20) when a tokenizer is given.  Decode failures are
skipped with a warning (reference generate_hdf5_file_5m.py:79-86).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import h5py
import numpy as np

from .tokenizers import WordPieceTokenizer, taxonomy_text

LEVELS = ("order", "family", "genus", "species")


def read_image_bytes(path: str, validate: bool = True) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            data = f.read()
        if validate:
            from PIL import Image
            import io

            Image.open(io.BytesIO(data)).verify()
        return data
    except Exception as e:  # skip-and-warn, like the reference
        print(f"Skipping unreadable image {path}: {e}")
        return None


def _encode_strings(values: Sequence[str]) -> np.ndarray:
    return np.array([str(v).encode("utf-8") for v in values])


def write_split_group(
    f: h5py.File,
    split: str,
    records: Dict[str, Sequence],
    jpeg_bytes: List[bytes],
    tokenizer: Optional[WordPieceTokenizer] = None,
    text_max_len: int = 20,
    compression: Optional[str] = None,
) -> None:
    """records must contain barcode, order/family/genus/species, sampleid,
    processid, image_file (parallel to jpeg_bytes)."""
    n = len(jpeg_bytes)
    g = f.create_group(split)
    kw = {"compression": compression} if compression else {}

    max_len = max((len(b) for b in jpeg_bytes), default=1)
    img = np.zeros((n, max_len), dtype=np.uint8)
    mask = np.zeros(n, dtype=np.int64)
    for i, b in enumerate(jpeg_bytes):
        img[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        mask[i] = len(b)
    g.create_dataset("image", data=img, **kw)
    g.create_dataset("image_mask", data=mask, **kw)

    g.create_dataset("barcode", data=_encode_strings(records["barcode"]), **kw)
    for level in LEVELS:
        g.create_dataset(level, data=_encode_strings(records[level]), **kw)
    for field in ("sampleid", "processid", "image_file"):
        g.create_dataset(field, data=_encode_strings(records[field]), **kw)

    if tokenizer is not None:
        texts = [
            taxonomy_text(records["order"][i], records["family"][i], records["genus"][i], records["species"][i])
            for i in range(n)
        ]
        toks = tokenizer.encode_batch(texts, max_length=text_max_len)
        g.create_dataset("language_tokens_input_ids", data=toks["input_ids"].astype(np.int64), **kw)
        g.create_dataset("language_tokens_token_type_ids", data=toks["token_type_ids"].astype(np.int64), **kw)
        g.create_dataset("language_tokens_attention_mask", data=toks["attention_mask"].astype(np.int64), **kw)


def build_split_hdf5(
    output_path: str,
    metadata,  # pandas DataFrame with columns: split + record fields
    image_dir: str,
    split_column: str = "split",
    image_file_column: str = "image_file",
    tokenizer: Optional[WordPieceTokenizer] = None,
    split_name_map: Optional[Dict[str, str]] = None,
    compression: Optional[str] = None,
) -> str:
    """Build the full split HDF5 from a metadata frame (the reference's
    create_splits output merged with the raw TSV columns).

    split_name_map renames source split labels to HDF5 group names, e.g.
    {"query_seen": "seen_keys", "single_species": "no_split"}."""
    split_name_map = split_name_map or {}
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with h5py.File(output_path, "w") as f:
        for split_value, frame in metadata.groupby(split_column):
            group_name = split_name_map.get(str(split_value), str(split_value))
            jpegs, keep = [], []
            for idx, row in frame.iterrows():
                data = read_image_bytes(os.path.join(image_dir, row[image_file_column]))
                if data is not None:
                    jpegs.append(data)
                    keep.append(idx)
            kept = frame.loc[keep]

            def col(*names, default=""):
                for name in names:
                    if name in kept.columns:
                        return list(kept[name])
                return [default] * len(kept)

            records = {
                "barcode": col("barcode", "nucraw"),
                "sampleid": col("sampleid"),
                "processid": col("processid", "sampleid"),
                "image_file": list(kept[image_file_column]),
            }
            for level in LEVELS:
                records[level] = col(level, default="not_classified")
            write_split_group(
                f, group_name, records, jpegs, tokenizer=tokenizer, compression=compression
            )
    return output_path


REFERENCE_SPLIT_NAME_MAP = {
    # create_splits.py labels → DATA.md HDF5 group names
    "query_seen": "seen_keys",
    "val_query_unseen": "val_unseen_keys",
    "test_query_unseen": "test_unseen_keys",
    "single_species": "no_split",
}
