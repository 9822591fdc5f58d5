"""Query → retrieved-image grids: the port of `clibd_tpu/engine/retrieval_grid.py`
(reference scripts/inference_and_eval.py:223-505 `retrieve_images`).

Queries are sampled from the cached features, searched against the key
gallery with the port's exact kNN (`ops.knn.knn_search`) on `device` (the
card unless the caller asks for the CPU), and both sides' images are read
from the split HDF5 for the grid figure and the record JSON.  The search
half of `retrieve_images_multi` is `retrieval_records`, which needs no HDF5
file, so it can run where h5py and matplotlib are absent.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.plots import retrieve_images_grid
from ..data.hdf5 import BioscanSplit
from ..data.transforms import decode_jpeg, resize_bilinear
from ..ops.knn import knn_search

DEFAULT_QUERY_KEYS: Tuple[Tuple[str, str], ...] = (
    ("encoded_image_feature", "encoded_image_feature"),
    ("encoded_image_feature", "encoded_dna_feature"),
    ("encoded_dna_feature", "encoded_dna_feature"),
)


def _thumb(jpeg: bytes, size: int = 128) -> np.ndarray:
    img = decode_jpeg(jpeg).astype(np.float32) / 255.0
    return resize_bilinear(img, size, size, antialias=True)


def retrieve_images(
    output_dir: str,
    hdf5_path: str,
    query_split: str,
    key_split: str,
    query_features: np.ndarray,
    key_features: np.ndarray,
    query_labels: List[dict],
    key_labels: List[dict],
    num_queries: int = 5,
    max_k: int = 3,
    seed: int = 413,
    level: str = "species",
    name: str = "retrieval",
    device: torch.device | str = "cuda",
) -> Dict:
    """→ record dict {query_id: {gt, retrieved: [...]}} + saved figure path."""
    rng = random.Random(seed)
    indices = rng.sample(range(len(query_features)), min(num_queries, len(query_features)))

    _sims, nn_idx = knn_search(np.asarray(query_features)[indices], key_features, k=max_k,
                               device=device)

    q_reader = BioscanSplit(hdf5_path, query_split)
    k_reader = BioscanSplit(hdf5_path, key_split)
    q_jpegs = q_reader.jpeg_bytes(np.asarray(indices))
    query_images = [_thumb(j) for j in q_jpegs]
    retrieved_images, retrieved_labels, correct = [], [], []
    record: Dict = {}
    q_ids = q_reader.ids(np.asarray(indices))
    for row_i, (qi, row) in enumerate(zip(indices, nn_idx)):
        k_jpegs = k_reader.jpeg_bytes(np.asarray(row))
        retrieved_images.append([_thumb(j) for j in k_jpegs])
        labels_row = [key_labels[i][level] for i in row]
        retrieved_labels.append(labels_row)
        gt = query_labels[qi][level]
        correct.append([l == gt for l in labels_row])
        record[q_ids[row_i]] = {
            "gt": query_labels[qi],
            "retrieved": [key_labels[i] for i in row],
        }
    q_reader.close()
    k_reader.close()

    os.makedirs(output_dir, exist_ok=True)
    fig_path = retrieve_images_grid(
        os.path.join(output_dir, f"{name}.png"),
        query_images,
        retrieved_images,
        query_labels=[query_labels[i][level] for i in indices],
        retrieved_labels=retrieved_labels,
        correct=correct,
    )
    with open(os.path.join(output_dir, f"{name}.json"), "w") as f:
        json.dump(record, f, indent=2)
    return {"figure": fig_path, "record": record}


def retrieval_records(
    query_dict: Dict,
    keys_dict: Dict,
    query_keys: Sequence[tuple] = DEFAULT_QUERY_KEYS,
    num_queries: int = 5,
    max_k: int = 3,
    seed: int = 413,
    level: str = "species",
    only_failures: bool = False,
    device: torch.device | str = "cuda",
) -> Tuple[Optional[List[int]], object]:
    """The searches of `retrieve_images_multi`: sample `num_queries` query
    rows (with only_failures, among those whose top-1 under the first usable
    pair has the wrong `level` label) and search each pair's top `max_k`
    keys on `device` → (indices, results in the record JSON's layout), or
    (None, a note) where only_failures finds no usable pair or no
    failure."""
    q_labels = query_dict["label_list"]
    k_labels = keys_dict["label_list"]
    q_ids_all = query_dict.get("processed_id_list", query_dict.get("file_name_list"))
    rng = random.Random(seed)
    n_q = len(q_labels)
    pool = range(n_q)
    if only_failures:
        # first pair whose features exist on both sides defines "failure"
        usable = [(qf, kf) for qf, kf in query_keys
                  if query_dict.get(qf) is not None and keys_dict.get(kf) is not None
                  and query_dict[qf].shape[-1] == keys_dict[kf].shape[-1]]
        if not usable:
            return None, "no usable feature pair"
        qf, kf = usable[0]
        _s, nn1 = knn_search(np.asarray(query_dict[qf]), np.asarray(keys_dict[kf]), k=1,
                             device=device)
        pool = [i for i in range(n_q)
                if k_labels[int(nn1[i][0])][level] != q_labels[i][level]]
        if not pool:
            return None, "no failure cases"
    indices = rng.sample(list(pool), min(num_queries, len(pool)))

    results = [{"query": {"index": int(i), "file_name": q_ids_all[i], "taxonomy": q_labels[i]},
                "results": []} for i in indices]
    for qf, kf in query_keys:
        qfeat = query_dict.get(qf)
        kfeat = keys_dict.get(kf)
        if qfeat is None or kfeat is None or qfeat.shape[-1] != kfeat.shape[-1]:
            for r in results:
                r["results"].append({"query_type": qf, "key_type": kf, "predictions": []})
            continue
        _sims, nn_idx = knn_search(np.asarray(qfeat)[indices], np.asarray(kfeat), k=max_k,
                                   device=device)
        for row_i, r in enumerate(results):
            r["results"].append({
                "query_type": qf,
                "key_type": kf,
                "predictions": [
                    {"index": int(j),
                     "file_name": keys_dict["processed_id_list"][j],
                     "taxonomy": k_labels[j]}
                    for j in nn_idx[row_i]
                ],
            })
    return indices, results


def retrieve_images_multi(
    output_dir: str,
    hdf5_path: str,
    query_split: str,
    key_split: str,
    query_dict: Dict,
    keys_dict: Dict,
    query_keys: List[tuple] = DEFAULT_QUERY_KEYS,
    num_queries: int = 5,
    max_k: int = 3,
    seed: int = 413,
    level: str = "species",
    independent: bool = True,
    load_cached_results: bool = False,
    only_failures: bool = False,
    name: str = "retrieved_images",
    device: torch.device | str = "cuda",
) -> Dict:
    """Multi-pair retrieval grids (reference retrieve_images
    inference_and_eval.py:223-505 with its `retrieve_settings` options):

    - query_keys: list of (query_feature_type, key_feature_type) pairs;
    - independent=True → one figure per pair; False → one combined figure
      with the query column followed by each pair's top-k block;
    - load_cached_results → reuse `<name>.json` instead of re-running kNN;
    - only_failures → sample queries whose top-1 retrieval (first pair) has
      the wrong `level` label (reference scripts/result/check_failure_cases.py).
    """
    os.makedirs(output_dir, exist_ok=True)
    json_path = os.path.join(output_dir, f"{name}.json")

    query_keys = list(query_keys)
    results = None
    if load_cached_results and os.path.exists(json_path):
        with open(json_path) as f:
            payload = json.load(f)
        # the cache must come from the same pair list: replaying it against
        # another pair order would mislabel figures (or IndexError on a
        # longer list)
        if isinstance(payload, dict) and [tuple(p) for p in payload.get("query_keys", [])] \
                == [tuple(p) for p in query_keys]:
            results = payload["results"]
            indices = [r["query"]["index"] for r in results]
        else:
            print(f"{json_path} was written with different query_keys — recomputing")
    if results is None:
        indices, results = retrieval_records(
            query_dict, keys_dict, query_keys, num_queries=num_queries, max_k=max_k, seed=seed,
            level=level, only_failures=only_failures, device=device)
        if indices is None:
            return {"figures": [], "record": [], "note": results}
        with open(json_path, "w") as f:
            json.dump({"query_keys": [list(p) for p in query_keys],
                       "results": results}, f, indent=2)

    q_reader = BioscanSplit(hdf5_path, query_split)
    k_reader = BioscanSplit(hdf5_path, key_split)
    query_images = [_thumb(j) for j in q_reader.jpeg_bytes(np.asarray(indices))]

    def pair_grids(pair_idx):
        retrieved_images, retrieved_labels, correct = [], [], []
        for r in results:
            preds = r["results"][pair_idx]["predictions"]
            idxs = np.asarray([p["index"] for p in preds], dtype=np.int64)
            imgs = [_thumb(j) for j in k_reader.jpeg_bytes(idxs)] if len(idxs) else []
            retrieved_images.append(imgs)
            labels_row = [p["taxonomy"][level] for p in preds]
            retrieved_labels.append(labels_row)
            gt = r["query"]["taxonomy"][level]
            correct.append([l == gt for l in labels_row])
        return retrieved_images, retrieved_labels, correct

    figures = []
    if independent:
        for pair_idx, (qf, kf) in enumerate(query_keys):
            ri, rl, corr = pair_grids(pair_idx)
            if not any(len(x) for x in ri):
                continue
            figures.append(retrieve_images_grid(
                os.path.join(output_dir, f"{name}_{qf}_to_{kf}.png"),
                query_images, ri,
                query_labels=[r["query"]["taxonomy"][level] for r in results],
                retrieved_labels=rl, correct=corr,
            ))
    else:
        # combined: query column + each pair's top-k block side by side
        all_ri = [[] for _ in results]
        all_rl = [[] for _ in results]
        all_corr = [[] for _ in results]
        for pair_idx in range(len(query_keys)):
            ri, rl, corr = pair_grids(pair_idx)
            if not any(len(x) for x in ri):
                continue
            for row in range(len(results)):
                all_ri[row].extend(ri[row])
                all_rl[row].extend(rl[row])
                all_corr[row].extend(corr[row])
        figures.append(retrieve_images_grid(
            os.path.join(output_dir, f"{name}_combined.png"),
            query_images, all_ri,
            query_labels=[r["query"]["taxonomy"][level] for r in results],
            retrieved_labels=all_rl, correct=all_corr,
        ))
    q_reader.close()
    k_reader.close()
    return {"figures": figures, "record": results, "json": json_path}
