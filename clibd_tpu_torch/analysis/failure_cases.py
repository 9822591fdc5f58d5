"""Paired failure-case figures: the port of `clibd_tpu/analysis/failure_cases.py`
(reference scripts/result/
show_paired_failure_cases.py:1-344): for selected (query, key) feature pairs,
find species-level top-1 mismatches and save a side-by-side figure — the
query specimen image titled with its ground-truth species next to the
retrieved top-1 key image titled with the (wrong) predicted species.

Unlike the reference (which builds an id→(split, position) map over the
whole HDF5, create_id_index_map), rows here are positional: extraction is
deterministic split order, so query row i is record i of its split — one
HDF5 slab read per figure batch, no global map.

The module is the JAX package's but for the device: `find_failures` and
`save_paired_failure_cases` search on `device` (the card unless the caller
asks for the CPU) through the port's `ops.knn.prepare_keys` / `knn_search`."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

QUERY_AND_KEY_WE_CARE_ABOUT: Tuple[Tuple[str, str], ...] = (
    ("encoded_image_feature", "encoded_image_feature"),
    ("encoded_dna_feature", "encoded_dna_feature"),
    ("encoded_image_feature", "encoded_dna_feature"),
)

_NAME = {"encoded_image_feature": "image", "encoded_dna_feature": "DNA",
         "encoded_language_feature": "text"}


def find_failures(query_dict: Dict, keys_dict: Dict, query_type: str,
                  key_type: str, max_cases: int = 10,
                  keys_prepared=None, device: torch.device | str = "cuda") -> List[dict]:
    """→ list of {query_row, key_row, gt_species, pred_species} for species
    top-1 mismatches of this (query, key) grid cell.

    keys_prepared: unit-norm key matrix on the device from
    ops.knn.prepare_keys — callers looping over (pair × split) cells pass it
    to avoid re-uploading/re-normalizing the same gallery per cell; the
    search then runs where it lies, else on `device`."""
    from ..ops.knn import knn_search

    q = query_dict.get(query_type)
    k = keys_dict.get(key_type)
    if q is None or k is None:
        return []
    if keys_prepared is not None:
        _, idx = knn_search(q, keys_prepared, k=1, keys_normalized=True, device=device)
    else:
        _, idx = knn_search(q, k, k=1, device=device)
    idx = idx[:, 0]
    gt = np.asarray([l["species"] for l in query_dict["label_list"]], dtype=object)
    pred = np.asarray([keys_dict["label_list"][j]["species"] for j in idx], dtype=object)
    rows = np.nonzero(gt != pred)[0]
    out = []
    for i in rows[:max_cases]:
        out.append({
            "query_row": int(i),
            "key_row": int(idx[i]),
            "gt_species": str(gt[i]),
            "pred_species": str(pred[i]),
            "query_id": query_dict.get("processed_id_list", [None] * len(gt))[i],
            "key_id": keys_dict.get("processed_id_list", [None] * len(idx))[int(idx[i])],
        })
    return out


def save_paired_failure_cases(
    folder: str,
    hdf5_path: str,
    seen_split: str,
    unseen_split: str,
    keys_split: str,
    seen_dict: Dict,
    unseen_dict: Dict,
    keys_dict: Dict,
    pairs: Sequence[Tuple[str, str]] = QUERY_AND_KEY_WE_CARE_ABOUT,
    max_cases: int = 10,
    device: torch.device | str = "cuda",
) -> List[str]:
    """Writes failure_cases/<seen|unseen>/<q>_to_<k>/<qid>_<kid>.png figures;
    → list of written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.hdf5 import BioscanSplit
    from ..data.transforms import decode_jpeg

    written: List[str] = []
    readers = {name: BioscanSplit(hdf5_path, split) for name, split in
               (("seen", seen_split), ("unseen", unseen_split), ("key", keys_split))}
    from ..ops.knn import prepare_keys

    prepared: Dict[str, object] = {}
    try:
        for query_type, key_type in pairs:
            if key_type not in prepared and keys_dict.get(key_type) is not None:
                prepared[key_type] = prepare_keys(keys_dict[key_type], device=device)
            for split_name, d in (("seen", seen_dict), ("unseen", unseen_dict)):
                cases = find_failures(d, keys_dict, query_type, key_type, max_cases,
                                      keys_prepared=prepared.get(key_type), device=device)
                if not cases:
                    continue
                sub = os.path.join(folder, split_name, f"{query_type}_to_{key_type}")
                os.makedirs(sub, exist_ok=True)
                q_rows = np.asarray([c["query_row"] for c in cases])
                k_rows = np.asarray([c["key_row"] for c in cases])
                q_jpegs = readers[split_name].jpeg_bytes(q_rows)
                k_jpegs = readers["key"].jpeg_bytes(k_rows)
                for c, qj, kj in zip(cases, q_jpegs, k_jpegs):
                    fig, ax = plt.subplots(1, 2, figsize=(6, 3.2))
                    ax[0].imshow(decode_jpeg(qj))
                    ax[0].set_title(f"GT: {c['gt_species']}", fontsize=8)
                    ax[1].imshow(decode_jpeg(kj))
                    ax[1].set_title(f"Pred: {c['pred_species']}", fontsize=8)
                    for a in ax:
                        a.axis("off")
                    fig.suptitle(
                        f"Query: {_NAME.get(query_type, query_type)} "
                        f"Key: {_NAME.get(key_type, key_type)}", fontsize=9)
                    fig.tight_layout()
                    qid = (c["query_id"] or f"q{c['query_row']}").split(".")[0]
                    kid = (c["key_id"] or f"k{c['key_row']}").split(".")[0]
                    path = os.path.join(sub, f"{qid}_{kid}.png")
                    fig.savefig(path, dpi=100)
                    plt.close(fig)
                    written.append(path)
    finally:
        for r in readers.values():
            r.close()
    return written
