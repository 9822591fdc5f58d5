# A copy of clibd_tpu/data/pipeline.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Host input pipeline: HDF5 → decoded/transformed fixed-shape batches →
prefetched device arrays.

Replaces the reference's torch DataLoader + DistributedSampler stack
(util/dataset.py:44-51, 390-471) with a thread-pool pipeline that does bulk
HDF5 slab reads, per-image JPEG decode + resize/crop (numpy, torch-parity —
see transforms.py; a C++ libjpeg pool accelerates decode when built), and
vectorized DNA tokenization per batch (no whole-split pre-tokenization — the
reference's 5M-scale CPU hot spot, dataset.py:416-429).

Sharding: each host shards the index space by (host_id, num_hosts); within a
batch the leading axis is laid out for the 'data' mesh axis.  Epoch shuffling
matches DistributedSampler semantics (seeded permutation per epoch,
drop_last).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from .hdf5 import BioscanSplit
from .tokenizers import tokenize_dna_batch
from .transforms import eval_transform, train_transform


@dataclass
class BatchSpec:
    batch_size: int = 64
    image_size: int = 224
    resize_to: int = 256
    dna_kmer: int = 5
    dna_max_bp: int = 660
    dna_tokenizer: str = "kmer"  # "kmer" | "overlap" (new-BarcodeBERT path)
    dna_stride: int = 1  # overlap tokenizer stride
    with_image: bool = True
    with_dna: bool = True
    with_language: bool = True
    train: bool = False
    long_edge_eval: bool = False  # `transform_with_resize` variant
    # SimCLR two-crop batches: decode once, emit image + image2 crops from
    # decorrelated aug streams (engine/simclr.TwoViewLoader)
    two_view: bool = False
    image_source: str = "image"  # "image" (jpeg) | "image_features"
    dna_source: str = "sequence"  # "sequence" | "dna_features"
    # optional callable(texts)->[B, ctx] ids for CLIP-backbone text (BPE at
    # batch time, reference SimpleCLIP open_clip path); None = the HDF5's
    # pre-tokenized BERT language_tokens_*
    clip_tokenizer: object = None

    @classmethod
    def eval_spec(cls, mc, batch_size: int = None) -> "BatchSpec":
        """The canonical eval-time BatchSpec for an ExperimentConfig — ONE
        place for the preprocessing contract shared by `clibd eval`,
        Trainer.evaluate's best-checkpoint selection, and verify-parity's
        re-extraction (a field added to one and not the others would make
        parity certification silently diverge from the eval it certifies)."""
        return cls(
            batch_size=mc.batch_size if batch_size is None else batch_size,
            train=False,
            transport_uint8=mc.amp,
            with_image=mc.image.enable,
            with_dna=mc.dna.enable,
            with_language=mc.language.enable,
            dna_kmer=mc.dna.kmer,
            dna_tokenizer=mc.dna.tokenizer,
            dna_stride=mc.dna.stride,
            dna_max_bp=mc.dna.max_bp,
            image_source="image" if mc.image.input_type == "image" else "image_features",
            dna_source="sequence" if mc.dna.input_type == "sequence" else "dna_features",
            long_edge_eval=mc.transform_with_resize,
            clip_tokenizer=cls.maybe_clip_tokenizer(mc),
        )

    @staticmethod
    def maybe_clip_tokenizer(mc):
        """CLIP BPE tokenizer for `backbone: open_clip` language batches
        (reference SimpleCLIP tokenizes taxonomy strings with open_clip's
        tokenizer at batch time rather than using the HDF5's pre-tokenized
        WordPiece ids).  None for the default BERT backbone."""
        if getattr(mc, "backbone", "default") == "open_clip" and mc.language.enable \
                and mc.clip.bpe_path:
            from .clip_tokenizer import CLIPTokenizer

            return CLIPTokenizer(mc.clip.bpe_path, context_length=mc.clip.context_length)
        return None
    # ship images host→device as uint8 (x255) instead of fp32 — 4× less
    # transfer; the model divides by 255 on device.  Pixel quantization
    # ≤0.5/255 (the decoder's own output grid), below bf16 compute noise.
    transport_uint8: bool = False


def preprocess_single_image(mc, image_bytes: bytes,
                            image_size: Optional[int] = None,
                            resize_to: Optional[int] = None) -> np.ndarray:
    """One image → the checkpoint's eval-transform output [H,W,3] f32.

    Shared by `cli extract-single` and the serve preprocessors so a
    `transform_with_resize` (long-edge) checkpoint is always queried with
    the SAME transform its gallery was extracted with (eval_spec
    long_edge_eval above)."""
    if image_size:
        size = image_size
    elif getattr(mc, "backbone", "default") == "open_clip":
        size = mc.clip.image_size  # clip tower geometry, not the BERT-path ViT's
    else:
        size = mc.image.vit.image_size
    return np.asarray(eval_transform(
        image_bytes, size=size,
        resize_to=resize_to or round(size * 256 / 224),
        long_edge=getattr(mc, "transform_with_resize", False)))


def tokenize_single_barcode(mc, barcode: str):
    """One barcode → model dna_input, honoring the checkpoint's configured
    tokenizer (the same dispatch as the batch pipeline below): overlap →
    token dict with attention mask; kmer → id row."""
    dc = mc.dna
    if dc.tokenizer == "overlap":
        from .tokenizers import tokenize_dna_batch_overlapping

        ids, att = tokenize_dna_batch_overlapping(
            [barcode], k=dc.kmer, stride=dc.stride, max_bp=dc.max_bp)
        return {"input_ids": ids[0], "attention_mask": att[0, : ids.shape[1]]}
    return np.asarray(
        tokenize_dna_batch([barcode], k=dc.kmer, max_bp=dc.max_bp))[0]


class Batch(dict):
    """dict with keys: 'image' [B,H,W,3] f32, 'dna' [B,133] i32,
    'language' {input_ids,token_type_ids,attention_mask} [B,20] i32,
    'label' [B] i64 (train) , 'index' [B] i64."""


def shard_indices(
    n: int,
    epoch: int,
    host_id: int = 0,
    num_hosts: int = 1,
    batch_size: int = 64,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """DistributedSampler-equivalent per-host index stream."""
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    if drop_last:
        per_host = n // num_hosts
        per_host -= per_host % batch_size
        return order[host_id::num_hosts][:per_host]
    # DistributedSampler pads to EQUAL per-host length by wrapping (later
    # hosts' strided slice is one short when num_hosts does not divide n) —
    # unequal counts would deadlock lockstep multi-host collectives.  An
    # EMPTY strided slice (n < num_hosts) must wrap from the global order,
    # like DistributedSampler's index-list padding, or that host would yield
    # zero batches while __len__ still promises one.
    per_host = -(-n // num_hosts)
    local = order[host_id::num_hosts]
    if len(local) == 0:
        local = order
    while len(local) < per_host:
        local = np.concatenate([local, local[: per_host - len(local)]])
    return local[:per_host]


class BioscanLoader:
    """Iterable over batches of one split.  `path`: the HDF5 file, or a
    `BioscanSplit` of the split to read through instead (a reader of
    records held in memory, such as `tools/rehearse.py`'s)."""

    def __init__(
        self,
        path: str,
        split: str,
        spec: BatchSpec,
        labels: Optional[np.ndarray] = None,
        host_id: int = 0,
        num_hosts: int = 1,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        decoder=None,
        use_native: bool = False,
        aug_seed: Optional[int] = None,
        limit: Optional[int] = None,
    ):
        self.split_reader = path if isinstance(path, BioscanSplit) else BioscanSplit(path, split)
        self.spec = spec
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed  # epoch permutation (shared across paired loaders)
        self.aug_seed = seed if aug_seed is None else aug_seed  # crop randomness
        self.n = len(self.split_reader)
        # optional head-of-split truncation (verify-parity --n slices: the
        # first `limit` records in split order, matching the row order of the
        # reference's released extracted_feature_*.hdf5 artifacts)
        self.limit = limit
        if limit is not None:
            self.n = min(self.n, int(limit))
        self.drop_last = spec.train if drop_last is None else drop_last
        # training labels: row index (instance discrimination) unless given
        # (reference dataset.py:155-163)
        self.labels = labels if labels is not None else np.arange(self.n, dtype=np.int64)
        if decoder is None and use_native:
            from .native import load_native_decoder

            decoder = load_native_decoder()
        self.decoder = decoder  # optional native C++ decode pool
        self._pool = ThreadPoolExecutor(max_workers=max(num_workers, 1)) if num_workers > 0 else None
        # Batch-level parallelism: whole batches (HDF5 slab read → decode →
        # tokenize → stack) assemble concurrently on this second pool, so DNA
        # tokenization and stacking of batch b+1 overlap the decode of batch b
        # (round-1 bottleneck: one producer thread serialized everything but
        # JPEG decode).  Separate pool from the per-image one — batch tasks
        # block on image tasks, sharing a pool would deadlock.
        self._batch_pool = (
            ThreadPoolExecutor(max_workers=min(max(num_workers, 1), max(prefetch, 1) + 1))
            if num_workers > 0 else None
        )
        # h5py file handles are not safe for concurrent reads — serialize them
        self._h5_lock = threading.Lock()
        # the native decoder spawns its own ncpu-thread pool per call —
        # concurrent batch builds calling it oversubscribe catastrophically
        # (measured 62 → 14 img/s on this host); one batch decodes at a time,
        # batch-level parallelism still overlaps the OTHER stages
        self._decoder_lock = threading.Lock()

    def __len__(self) -> int:
        per_host = self.n // self.num_hosts if self.drop_last else -(-self.n // self.num_hosts)
        if self.drop_last:
            return per_host // self.spec.batch_size
        return -(-per_host // self.spec.batch_size)

    def _make_batch(self, indices: np.ndarray, epoch: int, batch_idx: int) -> Batch:
        spec = self.spec
        out = Batch()
        out["index"] = indices.astype(np.int64)
        out["label"] = self.labels[indices]

        if spec.with_image:
            if spec.image_source == "image":
                with self._h5_lock:
                    jpegs = self.split_reader.jpeg_bytes(indices)
                rng = np.random.default_rng((self.aug_seed, epoch, batch_idx))
                if spec.two_view:
                    # SimCLR two-crop: decode + shorter-edge resize ONCE,
                    # then two random-resized crops from distinct aug
                    # streams (the python streams match the former
                    # twin-pipeline TwoViewLoader bit-for-bit: view 1 =
                    # (aug_seed, …, i), view 2 = (aug_seed+104729, …, i)) —
                    # halves host decode cost vs the reference's
                    # decode-per-view (util/dataset.py:328-367 calls the
                    # transform twice on one decode; round-2 layout decoded
                    # twice).
                    if self.decoder is not None:
                        # C++ two-view (decoder's own xorshift crop streams,
                        # like the existing native train path); rng already
                        # carries the (aug_seed, epoch, batch_idx) stream
                        r2 = np.random.default_rng(
                            (self.aug_seed + 104729, epoch, batch_idx))
                        with self._decoder_lock:
                            imgs, imgs2 = self.decoder.decode_transform_two_view(
                                jpegs, rng, r2, size=spec.image_size,
                                resize_to=spec.resize_to)
                    else:
                        from .transforms import decode_jpeg, random_resized_crop, resize_shorter_edge

                        def one_two(args):
                            i, data = args
                            img = decode_jpeg(data).astype(np.float32) / 255.0
                            img = resize_shorter_edge(img, spec.resize_to)
                            r1 = np.random.default_rng((self.aug_seed, epoch, batch_idx, i))
                            r2 = np.random.default_rng(
                                (self.aug_seed + 104729, epoch, batch_idx, i))
                            return (random_resized_crop(r1, img, spec.image_size),
                                    random_resized_crop(r2, img, spec.image_size))

                        if self._pool is not None:
                            pairs = list(self._pool.map(one_two, enumerate(jpegs)))
                        else:
                            pairs = [one_two(x) for x in enumerate(jpegs)]
                        imgs = [p[0] for p in pairs]
                        imgs2 = [p[1] for p in pairs]
                elif self.decoder is not None:
                    with self._decoder_lock:
                        imgs = self.decoder.decode_transform_batch(
                            jpegs, rng, train=spec.train,
                            size=spec.image_size, resize_to=spec.resize_to,
                            long_edge=spec.long_edge_eval,
                        )
                else:
                    def one(args):
                        i, data = args
                        if spec.train:
                            r = np.random.default_rng((self.aug_seed, epoch, batch_idx, i))
                            return train_transform(r, data, spec.image_size, spec.resize_to)
                        return eval_transform(data, spec.image_size, spec.resize_to,
                                              long_edge=spec.long_edge_eval)

                    if self._pool is not None:
                        imgs = list(self._pool.map(one, enumerate(jpegs)))
                    else:
                        imgs = [one(x) for x in enumerate(jpegs)]

                def pack(views):
                    # native paths return contiguous [B, H, W, 3] arrays —
                    # don't unstack/restack them
                    stacked = views if isinstance(views, np.ndarray) else np.stack(views)
                    if spec.transport_uint8:
                        return np.clip(np.round(stacked * 255.0), 0, 255).astype(np.uint8)
                    return np.asarray(stacked, np.float32)  # no-op for f32 native output

                out["image"] = pack(imgs)
                if spec.two_view:
                    out["image2"] = pack(imgs2)
            else:
                with self._h5_lock:
                    out["image"] = self.split_reader.features("image_features", indices)

        if spec.with_dna:
            if spec.dna_source == "sequence":
                with self._h5_lock:
                    barcodes = self.split_reader.barcodes(indices)
                if spec.dna_tokenizer == "overlap":
                    from .tokenizers import tokenize_dna_batch_overlapping

                    ids, att = tokenize_dna_batch_overlapping(
                        barcodes, k=spec.dna_kmer, stride=spec.dna_stride,
                        max_bp=spec.dna_max_bp,
                    )
                    # the mask carries the reference's max_bp//stride length
                    # quirk — the model needs it aligned to the ids width
                    out["dna"] = {"input_ids": ids,
                                  "attention_mask": att[:, : ids.shape[1]]}
                else:
                    out["dna"] = tokenize_dna_batch(barcodes, k=spec.dna_kmer,
                                                    max_bp=spec.dna_max_bp)
            else:
                with self._h5_lock:
                    out["dna"] = self.split_reader.features("dna_features", indices)

        if spec.with_language:
            if spec.clip_tokenizer is not None:
                with self._h5_lock:
                    texts = self.split_reader.taxonomy_strings(indices)
                out["language"] = {"input_ids": np.asarray(spec.clip_tokenizer(texts), np.int32)}
            else:
                with self._h5_lock:
                    out["language"] = self.split_reader.language_tokens(indices)
        return out

    def batches(self, epoch: int = 0, shuffle: Optional[bool] = None,
                start_batch: int = 0) -> Iterator[Batch]:
        """Yield batches with background prefetch (pipeline depth `prefetch`).

        start_batch: skip the first batches of the (deterministic, seeded)
        epoch stream — mid-epoch resume; batch indices (and therefore the
        per-batch augmentation streams) keep their absolute numbering."""
        shuffle = self.spec.train if shuffle is None else shuffle
        idx = shard_indices(
            self.n, epoch, self.host_id, self.num_hosts,
            self.spec.batch_size, shuffle=shuffle, drop_last=self.drop_last,
            seed=self.seed,
        )
        nb = len(idx) // self.spec.batch_size if self.drop_last else -(-len(idx) // self.spec.batch_size)
        if nb == 0 or start_batch >= nb:
            return

        def build(b: int) -> Batch:
            lo = b * self.spec.batch_size
            hi = min(lo + self.spec.batch_size, len(idx))
            return self._make_batch(idx[lo:hi], epoch, b)

        if self._batch_pool is None:
            for b in range(start_batch, nb):
                yield build(b)
            return

        # ordered pipeline: keep `prefetch+1` whole batches building
        # concurrently, yield strictly in order
        from collections import deque

        depth = max(self.prefetch, 1) + 1
        inflight: deque = deque()
        nxt = start_batch
        try:
            while nxt < min(start_batch + depth, nb):
                inflight.append(self._batch_pool.submit(build, nxt))
                nxt += 1
            while inflight:
                fut = inflight.popleft()
                item = fut.result()  # re-raises worker errors
                if nxt < nb:
                    inflight.append(self._batch_pool.submit(build, nxt))
                    nxt += 1
                yield item
        finally:
            for fut in inflight:
                fut.cancel()

    # reference returns the eval-style taxon dicts for non-training loaders
    def label_dicts(self) -> List[dict]:
        out = self.split_reader.label_dicts()
        return out[: self.n] if self.limit is not None else out

    def ids(self, field: str = "processid") -> List[str]:
        out = self.split_reader.ids(field=field)
        return out[: self.n] if self.limit is not None else out

    def close(self):
        # drain in-flight batch builds BEFORE closing the HDF5 reader — a
        # running build reading a closed h5py file raises (or worse) from a
        # background thread; cancel() cannot stop already-running futures
        if self._batch_pool is not None:
            self._batch_pool.shutdown(wait=True, cancel_futures=True)
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
        self.split_reader.close()
