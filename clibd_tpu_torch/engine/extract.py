"""Feature extraction: the port of `clibd_tpu/engine/extract.py`.

`extract_split` runs the tri-encoder over a split loader in eager PyTorch
under `torch.inference_mode()` and assembles the reference's split dict
(encoded_*_feature, averaged / concatenated features, labels, ids, and for
key sets all_key_features).  The cache writers produce the JAX package's
`extracted_feature_from_{split}_split.hdf5` group/dataset schema and its
labels / processed-id JSONs.

Overlap of host and device as in the reference (`extract.py:124-146`): batch
i's outputs are copied to pinned host memory asynchronously right after its
forward is launched, and the host waits for that copy only after batch i+1
has been launched.  Inputs go up from pinned memory without blocking, so the
loader builds the next batch while the card computes.

The embedding export (`extract.py:340-511`): `save_embedding_export` writes
a split dict as the reference's gzip HDF5 (encoded_*_feature and the
per-level label lists); `stream_extract_split` appends each batch to it
through `AppendableEmbeddingWriter` instead, with the same one-step-delayed
drain, and resumes a killed run from its consistent prefix.  The ragged last
batch needs no padding here (eager PyTorch has no compiled batch shape).
h5py is imported where a file is opened.

`extract_split_multihost` shards a split over the ranks of a process group:
each rank encodes the strided rows g::W on its own card, and the
embeddings are gathered so that every rank holds the whole split's dict.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import LEVELS, ExperimentConfig
from ..models.clibd import CLIBD, clibd_apply
from ..utils.profiling import loop_units, span

ALL_TYPE_OF_FEATURES_OF_QUERY = [
    "encoded_image_feature",
    "encoded_dna_feature",
    "encoded_language_feature",
    "averaged_feature",
    "concatenated_feature",
]
ALL_TYPE_OF_FEATURES_OF_KEY = ALL_TYPE_OF_FEATURES_OF_QUERY + ["all_key_features"]
MODALITIES = ("image", "dna", "language")
EXPORT_FEATURES = ("encoded_image_feature", "encoded_dna_feature", "encoded_language_feature")


def to_device(batch, device: torch.device):
    """numpy arrays (nested in dicts) → tensors on `device`; on a card they
    go up from pinned memory without blocking the host."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_encode_step(cfg: ExperimentConfig, model: CLIBD, compute_dtype=torch.bfloat16):
    """batch of device tensors → {image, dna, language} embeddings [B, D]."""

    def step(batch: dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            out = clibd_apply(model, cfg, image_input=batch.get("image"),
                              dna_input=batch.get("dna"),
                              language_input=batch.get("language"),
                              compute_dtype=compute_dtype)
        return {k: out[k] for k in MODALITIES if out[k] is not None}

    return step


def _encode_batches(model: CLIBD, cfg: ExperimentConfig, batches, compute_dtype):
    """Encode each batch on the model's device → yields, one batch late, its
    embeddings as fp32 host arrays {modality: [B, D]}.  Batch i's outputs go
    to pinned host memory asynchronously right after its forward is
    launched, and are waited for only after batch i+1 has been launched."""
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
    device = next(model.parameters()).device
    step = make_encode_step(cfg, model, compute_dtype)
    pending = None  # (host tensors, copy-done event) of the previous batch

    def drain(item):
        host, done = item
        if done is not None:
            done.synchronize()
        return {k: v.numpy().astype(np.float32, copy=False) for k, v in host.items()}

    for batch in loop_units(batches, "extract.next_batch"):
        model_batch = {k: batch[k] for k in MODALITIES if k in batch}
        with span("extract.to_device"):
            device_batch = to_device(model_batch, device)
        with span("extract.encode"):
            out = step(device_batch)
        with span("extract.to_host"):
            host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
            done = None
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        if pending is not None:
            with span("extract.drain"):
                arrays = drain(pending)
            yield arrays
        pending = (host, done)
    if pending is not None:
        with span("extract.drain"):
            arrays = drain(pending)
        yield arrays


def extract_split(model: CLIBD, cfg: ExperimentConfig, loader, for_key_set: bool = False,
                  compute_dtype=None, progress: bool = False) -> Dict:
    """Encode every batch of `loader` (the `BioscanLoader` interface:
    `batches(epoch, shuffle)`, `label_dicts()`, `ids()`) on the model's
    device → the split dict.  compute_dtype follows cfg.amp by default."""
    feats: Dict[str, list] = {m: [] for m in MODALITIES}
    t0 = time.time()
    total = 0
    for host in _encode_batches(model, cfg, loader.batches(epoch=0, shuffle=False),
                                compute_dtype):
        for k, v in host.items():
            feats[k].append(v)
        total += next(iter(host.values())).shape[0]
        if progress:
            dt = time.time() - t0
            print(f"\rencoded {total} samples ({total / max(dt, 1e-9):.1f}/s)", end="")
    if progress:
        print()

    enc = {k: (np.concatenate(v, axis=0) if v else None) for k, v in feats.items()}
    return finalize_split_dict(enc, loader.label_dicts(), loader.ids(), for_key_set,
                               strict_all_keys=getattr(cfg, "parity_strict", False))


def extract_split_multihost(model: CLIBD, cfg: ExperimentConfig, path: Optional[str],
                            split: str, spec, for_key_set: bool = False, num_workers: int = 2,
                            use_native: bool = False, progress: bool = False,
                            make_loader=None, mesh=None) -> Dict:
    """`extract_split` with the split sharded over the ranks
    (`clibd_tpu/engine/extract.py:194-258`): rank g encodes the strided rows
    g::W, wrap-padded to equal counts as `shard_indices(drop_last=False)`
    gives them, the embeddings are all-gathered, the padding dropped and
    the rows put back in split order, so every rank returns the whole
    split's dict.  Labels and ids are metadata every rank reads whole.

    make_loader(host_id, num_hosts): a loader over one rank's shard (whose
    label_dicts() and ids() are the whole split's) in place of
    `BioscanLoader(path, split, spec, host_id=, num_hosts=,
    drop_last=False)`.  mesh: default `create_mesh()`.  With one rank it is
    `extract_split` over the whole split."""
    from ..parallel.mesh import all_gather_tensor, create_mesh

    mesh = mesh if mesh is not None else create_mesh()
    g, n_ranks = (mesh.rank, mesh.size) if mesh.group is not None else (0, 1)
    if make_loader is None:
        from ..data.pipeline import BioscanLoader

        def make_loader(host_id, num_hosts):
            return BioscanLoader(path, split, spec, host_id=host_id, num_hosts=num_hosts,
                                 num_workers=num_workers, use_native=use_native,
                                 drop_last=False)

    loader = make_loader(g, n_ranks)
    try:
        if n_ranks == 1:
            return extract_split(model, cfg, loader, for_key_set=for_key_set, progress=progress)
        local = extract_split(model, cfg, loader, for_key_set=False, progress=progress)
        label_list, ids = loader.label_dicts(), loader.ids()
    finally:
        loader.close()
    n_total = len(label_list)
    counts = [len(range(r, n_total, n_ranks)) for r in range(n_ranks)]
    enc: Dict = {}
    for modality in MODALITIES:
        arr = local[f"encoded_{modality}_feature"]
        if arr is None:
            enc[modality] = None
            continue
        gathered = all_gather_tensor(torch.from_numpy(np.asarray(arr, np.float32)),
                                     mesh.group).numpy().reshape(n_ranks, -1, arr.shape[1])
        full = np.empty((n_total, arr.shape[1]), np.float32)
        for r in range(n_ranks):
            full[r::n_ranks] = gathered[r][:counts[r]]
        enc[modality] = full
    return finalize_split_dict(enc, label_list, ids, for_key_set,
                               strict_all_keys=getattr(cfg, "parity_strict", False))


def finalize_split_dict(enc: Dict, label_list, ids, for_key_set: bool,
                        strict_all_keys: bool = False) -> Dict:
    """Derived features + labels/ids from the per-modality encoded matrices
    (`extract.py:156-191`)."""
    averaged = concatenated = None
    if enc["image"] is not None and enc["dna"] is not None:
        averaged = np.mean([enc["image"], enc["dna"]], axis=0)
        concatenated = np.concatenate([enc["image"], enc["dna"]], axis=1)

    out_dict: Dict = {
        "file_name_list": ids,
        "processed_id_list": ids,
        "encoded_image_feature": enc["image"],
        "encoded_dna_feature": enc["dna"],
        "encoded_language_feature": enc["language"],
        "averaged_feature": averaged,
        "concatenated_feature": concatenated,
        "label_list": label_list,
    }
    all_key_features = all_key_features_label = None
    if for_key_set:
        # the reference demands all three modalities; >=2 keeps the All-keys
        # column for image+DNA models, parity_strict restores the reference
        present = [enc[m] for m in MODALITIES if enc[m] is not None]
        if len(present) >= (3 if strict_all_keys else 2):
            all_key_features = np.concatenate(present, axis=0)
            all_key_features_label = label_list * len(present)
    out_dict["all_key_features"] = all_key_features
    out_dict["all_key_features_label"] = all_key_features_label
    return out_dict


# ---------------------------------------------------------------------------
# Cache IO (`extract.py:266-331`; reference scripts/inference_and_eval.py)
# ---------------------------------------------------------------------------


def save_extracted_features(path: str, seen_dict: Dict, unseen_dict: Dict, keys_dict: Dict) -> None:
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        for split_name, split in (("seen", seen_dict), ("unseen", unseen_dict), ("key", keys_dict)):
            group = f.create_group(split_name)
            for embedding_type in ALL_TYPE_OF_FEATURES_OF_KEY:
                if embedding_type in split and split[embedding_type] is not None:
                    group.create_dataset(embedding_type, data=split[embedding_type])


def save_labels_and_ids(labels_path: str, processed_id_path: str, seen_dict: Dict,
                        unseen_dict: Dict, keys_dict: Dict) -> None:
    with open(labels_path, "w") as f:
        json.dump({"seen_gt_dict": seen_dict["label_list"],
                   "unseen_gt_dict": unseen_dict["label_list"],
                   "key_gt_dict": keys_dict["label_list"]}, f, indent=4)
    with open(processed_id_path, "w") as f:
        json.dump({"seen_id_list": seen_dict["file_name_list"],
                   "unseen_id_list": unseen_dict["file_name_list"],
                   "key_id_list": keys_dict["file_name_list"]}, f, indent=4)


def load_extracted_features(path: str, labels_path: str, processed_id_path: str):
    """Reload cached embeddings → (seen_dict, unseen_dict, keys_dict)."""
    import h5py

    seen_dict: Dict = {}
    unseen_dict: Dict = {}
    keys_dict: Dict = {}
    with h5py.File(path, "r") as f:
        for name, d in (("seen", seen_dict), ("unseen", unseen_dict), ("key", keys_dict)):
            for t in ALL_TYPE_OF_FEATURES_OF_KEY:
                if t in f[name]:
                    d[t] = f[name][t][:]
    with open(labels_path) as jf:
        total = json.load(jf)
    seen_dict["label_list"] = total["seen_gt_dict"]
    unseen_dict["label_list"] = total["unseen_gt_dict"]
    keys_dict["label_list"] = total["key_gt_dict"]
    # all_key_features stacks the PRESENT modalities: derive the multiplier
    # from the stored shape so a reload round-trips extract_split exactly
    n_keys = max(len(total["key_gt_dict"]), 1)
    akf = keys_dict.get("all_key_features")
    reps = (akf.shape[0] // n_keys) if akf is not None else 3
    keys_dict["all_key_features_label"] = total["key_gt_dict"] * reps
    with open(processed_id_path) as jf:
        ids = json.load(jf)
    seen_dict["processed_id_list"] = ids["seen_id_list"]
    unseen_dict["processed_id_list"] = ids["unseen_id_list"]
    keys_dict["processed_id_list"] = ids["key_id_list"]
    keys_dict["all_processed_id_list"] = ids["key_id_list"] * reps
    return seen_dict, unseen_dict, keys_dict


# ---------------------------------------------------------------------------
# Embedding export (`extract.py:340-511`; reference scripts/save_embedding/
# extract_embedding.py: gzip HDF5 with encoded_*_feature + per-level label
# lists, Embedding.md:1-30)
# ---------------------------------------------------------------------------


def save_embedding_export(path: str, split_dict: Dict, compress: bool = True) -> None:
    import h5py

    kw = {"compression": "gzip"} if compress else {}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        for t in EXPORT_FEATURES:
            if split_dict.get(t) is not None:
                f.create_dataset(t, data=split_dict[t], **kw)
        labels = split_dict["label_list"]
        for level in LEVELS:
            names = np.array([lab[level].encode() for lab in labels])
            f.create_dataset(f"{level}_list", data=names, **kw)
        f.create_dataset("file_name",
                         data=np.array([s.encode() for s in split_dict["file_name_list"]]), **kw)


class AppendableEmbeddingWriter:
    """Batch-resizable gzip HDF5 embedding writer (reference
    scripts/save_embedding/extract_embedding_for_backend.py): datasets are
    created with unlimited maxshape and appended per batch, so large exports
    stream without holding everything in RAM."""

    def __init__(self, path: str, feature_dim: int, compress: bool = True,
                 resume: bool = False):
        import h5py

        self._str_dtype = h5py.string_dtype()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        mode = "a" if (resume and os.path.exists(path)) else "w"
        self.file = h5py.File(path, mode)
        self.kw = {"compression": "gzip"} if compress else {}
        self.feature_dim = feature_dim
        self._datasets = {name: self.file[name] for name in self.file.keys()} if mode == "a" else {}
        # a kill mid-append can leave datasets at different lengths (they are
        # resized one at a time): the consistent prefix is the minimum
        self._n = min(ds.shape[0] for ds in self._datasets.values()) if self._datasets else 0

    @property
    def n_rows(self) -> int:
        """Rows present in every dataset (the consistent prefix)."""
        return self._n

    def truncate(self, n: int) -> None:
        """Trim every dataset to its first `n` rows: resume cuts a killed
        run's possibly inconsistent tail back to a batch boundary."""
        for ds in self._datasets.values():
            if ds.shape[0] > n:
                ds.resize(n, axis=0)
        self._n = min(n, self._n)

    def _ensure(self, name: str, shape_tail, dtype):
        if name not in self._datasets:
            self._datasets[name] = self.file.create_dataset(
                name, shape=(0, *shape_tail), maxshape=(None, *shape_tail), dtype=dtype,
                chunks=True, **self.kw)
        return self._datasets[name]

    def _append_rows(self, name: str, rows, shape_tail, dtype) -> None:
        ds = self._ensure(name, shape_tail, dtype)
        start = ds.shape[0]
        ds.resize(start + len(rows), axis=0)
        ds[start:start + len(rows)] = rows

    def append(self, features: Dict[str, np.ndarray], label_dicts, file_names) -> None:
        n = len(file_names)
        if n == 0:
            return  # ds[-0:] would select every row
        for t, arr in features.items():
            if arr is not None:
                self._append_rows(t, arr, (arr.shape[1],), np.float32)
        for level in LEVELS:
            self._append_rows(f"{level}_list", [lab[level] for lab in label_dicts], (),
                              self._str_dtype)
        # the rows reach the file before file_name grows to claim them, so a
        # process killed mid-append leaves file_name, and with it the
        # consistent prefix, short of any row whose data was not written
        self.file.flush()
        self._append_rows("file_name", list(file_names), (), self._str_dtype)
        self.file.flush()
        self._n += n

    def close(self) -> None:
        self.file.close()


def stream_extract_split(model: CLIBD, cfg: ExperimentConfig, loader, out_path: str,
                         resume: bool = False, compress: bool = True, progress: bool = False,
                         max_batches: Optional[int] = None, compute_dtype=None) -> int:
    """Streaming embedding export: encode a split batch by batch on the
    model's device and append each batch to `out_path`
    (`AppendableEmbeddingWriter`), writing batch i while the card encodes
    batch i+1.

    resume=True continues a partial output: its consistent prefix is cut to
    a batch boundary and extraction restarts at that batch
    (`loader.batches(start_batch=...)`); the loader's fixed shuffle=False
    order makes the file bit-identical to an uninterrupted run.
    max_batches stops after that many batches.  Returns the records written
    by this call.  Single process."""
    bs = loader.spec.batch_size
    labels = loader.label_dicts()
    ids = loader.ids()
    writer = AppendableEmbeddingWriter(out_path, feature_dim=cfg.output_dim, compress=compress,
                                       resume=resume)
    try:
        done = (writer.n_rows // bs) * bs  # consistent prefix → batch boundary
        if resume and writer.n_rows != done:
            writer.truncate(done)
        batches = loader.batches(epoch=0, shuffle=False, start_batch=done // bs)
        if max_batches is not None:
            batches = itertools.islice(batches, max_batches)
        t0 = time.time()
        written = 0
        for host in _encode_batches(model, cfg, batches, compute_dtype):
            n = next(iter(host.values())).shape[0]
            writer.append({f"encoded_{k}_feature": v for k, v in host.items()},
                          labels[done:done + n], ids[done:done + n])
            done += n
            written += n
            if progress:
                dt = time.time() - t0
                print(f"\rstreamed {done}/{len(labels)} records "
                      f"({written / max(dt, 1e-9):.1f}/s this run)", end="")
        if progress:
            print()
    finally:
        writer.close()
    return written
