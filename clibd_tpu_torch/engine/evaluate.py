"""Retrieval evaluation: the port of `clibd_tpu/engine/evaluate.py`.

The reference's metric grid -- micro and macro top-k accuracy x 4 taxonomic
levels x {seen, unseen} x every (query feature type x key feature type) --
over the exact kNN of `ops.knn`, with the port's copies of the JAX package's
metrics (`utils/metrics.py`) and table (`utils/table.py`), and the
reference's ASCII table, accuracy.json / results.csv / raw.csv writers.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.knn import knn_search, prepare_keys
from ..utils.metrics import (
    LEVELS,
    labels_to_level_arrays,
    predictions_to_level_arrays,
    top_k_macro_accuracy,
    top_k_micro_accuracy,
)
from ..utils.table import Table
from .extract import ALL_TYPE_OF_FEATURES_OF_KEY, ALL_TYPE_OF_FEATURES_OF_QUERY


def _pred_lists(preds_by_level, n: int) -> List[dict]:
    """Per-query {level: [k labels]} dicts (reference pred_dict payload)."""
    return [{level: list(preds_by_level[level][i]) for level in LEVELS} for i in range(n)]


def inference_and_eval(keys_dict: Dict, seen_dict: Dict, unseen_dict: Dict,
                       k_list: Sequence[int] = (1, 3, 5), query_chunk: int = 4096,
                       with_preds: bool = True,
                       device: torch.device | str = "cuda") -> tuple:
    """→ (acc_dict, per_class_acc, pred_dict) with the reference's nesting:
    acc_dict[query_type][key_type][seen|unseen][micro_acc|macro_acc][k][level].
    Each key matrix and each query matrix goes to `device` once."""
    device = torch.device(device)
    acc_dict: Dict = {}
    per_class_acc: Dict = {}
    max_k = max(k_list)

    seen_gt = labels_to_level_arrays(seen_dict["label_list"])
    unseen_gt = labels_to_level_arrays(unseen_dict["label_list"])
    base_key_labels = labels_to_level_arrays(keys_dict["label_list"])
    pred_dict: Dict = {
        "seen_id": seen_dict.get("processed_id_list", seen_dict.get("file_name_list", [])),
        "seen_gt_label": seen_dict["label_list"],
        "unseen_id": unseen_dict.get("processed_id_list", unseen_dict.get("file_name_list", [])),
        "unseen_gt_label": unseen_dict["label_list"],
    }
    prepared_keys: Dict = {}
    dev_queries: Dict = {}

    def query_on_device(split_id, qtype, arr):
        if (split_id, qtype) not in dev_queries:
            dev_queries[(split_id, qtype)] = torch.from_numpy(
                np.asarray(arr, np.float32)).to(device)
        return dev_queries[(split_id, qtype)]

    def predict(queries, keys_prep, key_labels):
        _, indices = knn_search(queries, keys_prep, k=max_k, query_chunk=query_chunk,
                                keys_normalized=True)
        return predictions_to_level_arrays(indices, key_labels)

    akf_key_labels = None
    for query_type in ALL_TYPE_OF_FEATURES_OF_QUERY:
        if seen_dict.get(query_type) is None:
            continue
        acc_dict[query_type] = {}
        per_class_acc[query_type] = {}
        pred_dict[query_type] = {}
        for key_type in ALL_TYPE_OF_FEATURES_OF_KEY:
            if keys_dict.get(key_type) is None:
                continue
            key_labels = base_key_labels
            if key_type == "all_key_features":
                if akf_key_labels is None:
                    akf_key_labels = labels_to_level_arrays(keys_dict["all_key_features_label"])
                key_labels = akf_key_labels
            q_seen = seen_dict[query_type]
            q_unseen = unseen_dict.get(query_type)
            keys_feature = keys_dict[key_type]
            if (q_seen is None or q_unseen is None
                    or keys_feature.shape[-1] != q_seen.shape[-1]
                    or keys_feature.shape[-1] != q_unseen.shape[-1]):
                continue
            if key_type not in prepared_keys:
                prepared_keys[key_type] = prepare_keys(keys_feature, device=device)
            keys_prep = prepared_keys[key_type]
            seen_preds = predict(query_on_device("seen", query_type, q_seen), keys_prep, key_labels)
            unseen_preds = predict(query_on_device("unseen", query_type, q_unseen), keys_prep,
                                   key_labels)

            entry: Dict = {"seen": {}, "unseen": {}}
            entry["seen"]["micro_acc"] = top_k_micro_accuracy(seen_preds, seen_gt, k_list)
            entry["unseen"]["micro_acc"] = top_k_micro_accuracy(unseen_preds, unseen_gt, k_list)
            seen_macro, seen_pc = top_k_macro_accuracy(seen_preds, seen_gt, k_list)
            unseen_macro, unseen_pc = top_k_macro_accuracy(unseen_preds, unseen_gt, k_list)
            entry["seen"]["macro_acc"] = seen_macro
            entry["unseen"]["macro_acc"] = unseen_macro
            acc_dict[query_type][key_type] = entry
            per_class_acc[query_type][key_type] = {"seen": seen_pc, "unseen": unseen_pc}
            if with_preds:
                pred_dict[query_type][key_type] = {
                    "curr_seen_pred_list": _pred_lists(seen_preds, len(seen_dict["label_list"])),
                    "curr_unseen_pred_list": _pred_lists(unseen_preds,
                                                         len(unseen_dict["label_list"])),
                }
    return acc_dict, per_class_acc, pred_dict


# ---------------------------------------------------------------------------
# Reporting (`evaluate.py:173-285`; reference util/util.py:397-519)
# ---------------------------------------------------------------------------

_CSV_NAME = {
    "encoded_image_feature": "Image",
    "encoded_dna_feature": "DNA",
    "encoded_language_feature": "Text",
    "averaged_feature": "Ave",
    "concatenated_feature": "Concat",
    "all_key_features": "All",
}

_HEADER = [
    " ",
    "Seen Order", "Seen Family", "Seen Genus", "Seen Species",
    "Unseen Order", "Unseen Family", "Unseen Genus", "Unseen Species",
]


def format_results(acc_dict: Dict, k_list: Sequence[int] = (1, 3, 5), alignment: str = "I,D,T",
                   meta: Optional[Dict] = None) -> tuple:
    """→ (table_str, csv_rows, raw_rows, copy_rows).  meta supplies the CSV
    context columns (learning_strategy, encoders, epochs, dim)."""
    meta = meta or {}
    suffix = f"({alignment})"
    row_prefix = [
        meta.get("learning_strategy", "LoRA"),
        alignment,
        meta.get("dna_encoder", "barcode_bert"),
        meta.get("image_encoder", "vit"),
        meta.get("language_encoder", "bert_small"),
        meta.get("epochs", 0),
        meta.get("output_dim", 768),
    ]
    csv_rows = [[
        "learning_strategy", "Alignment", "DNA_encoder", "Image_encoder",
        "Language_encoder", "Epoch", "Latent_space_dim", "Query", "Key", "Metric",
        "Seen_Order", "Seen_Family", "Seen_Genus", "Seen_Species",
        "Unseen_Order", "Unseen_Family", "Unseen_Genus", "Unseen_Species",
    ]]
    rows = []
    copy_rows = []
    for query_type in ALL_TYPE_OF_FEATURES_OF_QUERY:
        if query_type not in acc_dict:
            continue
        for key_type in ALL_TYPE_OF_FEATURES_OF_KEY:
            if key_type not in acc_dict[query_type]:
                continue
            for acc_type in ("micro_acc", "macro_acc"):
                for k in k_list:
                    if not acc_dict[query_type][key_type]:
                        continue
                    qn = _CSV_NAME[query_type]
                    kn = _CSV_NAME[key_type]
                    if qn in ("Ave", "Concat"):
                        qn += suffix
                    if kn in ("Ave", "Concat", "All"):
                        kn += suffix
                    row = [f"Query_feature: {query_type}||Key_feature: {key_type}||{acc_type} top-{k}"]
                    copy_row = ""
                    csv_row = row_prefix + [qn, kn, acc_type.replace("m", "M").replace("_", f"_Top-{k}_")]
                    for split in ("seen", "unseen"):
                        for level in LEVELS:
                            num = round(acc_dict[query_type][key_type][split][acc_type][k][level], 4)
                            row.append(f"\t{num}")
                            copy_row += f"{num}\t"
                            csv_row.append(num)
                    rows.append(row)
                    copy_rows.append(copy_row)
                    csv_rows.append(csv_row)
    table = Table(_HEADER, rows)
    raw_rows = [r[-8:] for r in csv_rows[1:]]
    return table.format(), csv_rows, raw_rows, copy_rows


def save_results(logs_dir: str, acc_dict: Dict, csv_rows, raw_rows,
                 config_snapshot: Optional[dict] = None) -> None:
    """accuracy.json / results.csv / raw.csv / config.yaml."""
    os.makedirs(logs_dir, exist_ok=True)
    with open(os.path.join(logs_dir, "accuracy.json"), "w") as f:
        json.dump(stringify(acc_dict), f)
    with open(os.path.join(logs_dir, "results.csv"), "w", newline="") as f:
        csv.writer(f, delimiter=",").writerows(csv_rows)
    with open(os.path.join(logs_dir, "raw.csv"), "w", newline="") as f:
        csv.writer(f, delimiter=",").writerows(raw_rows)
    if config_snapshot is not None:
        import yaml

        with open(os.path.join(logs_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(config_snapshot, f, sort_keys=False)


def stringify(obj):
    """JSON-ready copy: dict keys as str, numpy scalars as Python numbers."""
    if isinstance(obj, dict):
        return {str(k): stringify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [stringify(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    return obj


def convert_acc_dict_to_wandb_dict(acc_dict: Dict) -> Dict:
    """Flatten the grid for logging (reference train_cl.py:110-121)."""
    out = {}
    for q, by_key in acc_dict.items():
        for kt, entry in by_key.items():
            for split in ("seen", "unseen"):
                for acc_type in ("micro_acc", "macro_acc"):
                    for k, by_level in entry[split][acc_type].items():
                        for level, v in by_level.items():
                            out[f"{q}||{kt}||{split}||{acc_type}||top-{k}||{level}"] = v
    return out


def compute_overall_acc(acc_dict: Dict, k: int = 1) -> float:
    """Model-selection scalar (reference train_cl.py:123-142): mean of micro
    and macro top-1 over every level, split and query/key pair present."""
    vals = []
    for by_key in acc_dict.values():
        for entry in by_key.values():
            for split in ("seen", "unseen"):
                for acc_type in ("micro_acc", "macro_acc"):
                    by_level = entry[split][acc_type].get(k)
                    if by_level:
                        vals.extend(by_level.values())
    return float(np.mean(vals)) if vals else 0.0
