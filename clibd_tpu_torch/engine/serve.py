"""Online inference service: the port of `clibd_tpu/engine/serve.py`, resident
serving of a trained CLIBD model on one card.

The reference ships the pieces a website backend needs (scripts/save_embedding/
extract_embedding_for_backend.py streams per-record embeddings to an
appendable HDF5; extract_embedding_for_single_image.py embeds one record per
process) but no resident server: every request would pay process start and
checkpoint load.  Here one process holds the model on the card, and
concurrent requests are coalesced into one padded forward per modality, so
a batch of many records pays one set of kernel launches.

Design:

- ``InferenceService`` holds the port's ``CLIBD`` module and runs one eager
  forward per modality under bf16 (``clibd_apply``'s default, as in the JAX
  package).  Batches are padded up to the next bucket size, so the kernels
  see a fixed set of shapes (``pre_warm`` runs each once, before traffic),
  and results are sliced back per request: batch rows are independent
  through ViT/BERT (LayerNorm is per token, attention per sample), so
  padding rows cannot perturb real rows.
- Micro-batching: callers enqueue ``(payload, Future)`` from any thread; a
  single batcher thread drains up to ``max_batch`` requests arriving within
  ``window_ms`` of the first, runs one forward per modality present, and
  resolves the futures.  Host-side decode (JPEG → array) happens on the
  caller's thread.  ``torch.inference_mode`` is thread-local, so the
  forward enters it on whichever thread runs it.
- Optional key set: a ``save_embedding_export`` HDF5 (the backend-export
  schema) is uploaded and L2-normalised on the card once (``KeySet``);
  ``search`` runs kNN (``ops.knn``: exact, or the int8 gallery with an exact
  host re-rank) and maps indices to the 4-level taxonomy.
  ``KeySet.from_arrays`` builds the same from arrays in memory.

The HTTP layer (``make_server``) is stdlib ``ThreadingHTTPServer``: each
connection gets a thread, which is the concurrency the batcher coalesces.
``ServeStats``, ``open_gallery_readonly`` and the HTTP handler are copied
from the JAX package's module.

The key-sharded gallery (``KeySet(mesh=)``, ``InferenceService(keys_mesh=)``,
``serve --shard-keys``): the rows split over a list of local devices, each
search the key-sharded exact top k of ``ops.knn`` (each device's own top k,
the candidates merged), for a gallery larger than one card's memory.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.schema import LEVELS
from ..ops.knn import QuantizedKeys, ShardedKeys, knn_search, prepare_keys, rerank_candidates
from .extract import EXPORT_FEATURES, to_device



def _next_bucket(n: int, buckets) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


@dataclass
class ServeStats:
    """Lock-protected rolling telemetry (exposed at GET /stats)."""

    requests: int = 0
    batches: int = 0
    errors: int = 0
    batch_size_sum: int = 0
    latencies_ms: List[float] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    max_latencies: int = 4096

    def record_batch(self, size: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_size_sum += size

    def record_request(self, latency_ms: float) -> None:
        with self._lock:
            self.requests += 1
            self.latencies_ms.append(latency_ms)
            if len(self.latencies_ms) > self.max_latencies:
                del self.latencies_ms[: len(self.latencies_ms) // 2]

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self.latencies_ms)
            pct = lambda p: (lat[min(len(lat) - 1, int(p * len(lat)))] if lat else None)  # noqa: E731
            return {
                "requests": self.requests,
                "batches": self.batches,
                "errors": self.errors,
                "mean_batch_size": (self.batch_size_sum / self.batches) if self.batches else None,
                "p50_ms": pct(0.50),
                "p95_ms": pct(0.95),
            }


class Overloaded(RuntimeError):
    """Backlog exceeded max_queue: shed with HTTP 503, fail fast."""


def open_gallery_readonly(path: str):
    """Open a gallery HDF5 for reading without taking the HDF5 file lock.

    A resident server's read must never hold a lock that blocks the
    gallery writer (the reference's backend flow appends continuously: a
    writer failed "unable to truncate a file which is already open"
    mid-reload).  Torn concurrent reads are handled upstream: reload fails
    -> old gallery serves -> the watcher retries after write-stability.
    Falls back to a locked open only on h5py/libhdf5 builds without the
    ``locking`` kwarg (TypeError/ValueError at call time); an OSError
    (torn/missing file) propagates to the reload retry path.
    """
    import h5py

    try:
        return h5py.File(path, "r", locking=False)
    except (TypeError, ValueError):
        return h5py.File(path, "r")


class KeySet:
    """Preloaded retrieval gallery from a save_embedding_export HDF5
    (`engine/extract.py`'s backend-export schema): per-modality key
    matrices on the card, normalised once, and the 4-level label table.

    max_k: every device search runs at this single fixed width and the
    result is sliced to the requested k on the host, as in the JAX package
    (where a per-request k would compile a program per value).

    dtype="int8": the int8 gallery (`ops.knn.QuantizedKeys`, 4x smaller).
    selector: "auto" keeps the JAX package's policy: candidate selection
    "approx" where the fp32 host re-rank restores an exact final top-k
    (int8 with rerank_oversample > 0), "exact" elsewhere; "exact"/"approx"
    force.  The re-rank (the original fp32 rows in host memory) is on for
    int8 always and for fp32 under explicit "approx"; fp32 + "auto" stays
    exact on the card with no host copy.  0 disables it.  "approx" selects
    exactly on the card (`ops.knn.knn_search`).

    mesh: a list of local devices (or a `parallel.Mesh`; one card may be
    named twice) to shard each key matrix's rows over (`ops.knn.ShardedKeys`,
    the JAX package's resident layout for a gallery larger than one chip);
    every search is then the key-sharded exact top k, and `device` is
    unused."""

    def __init__(self, path: str, mesh=None, max_k: int = 16, dtype: str = "float32",
                 rerank_oversample: int = 4, selector: str = "auto",
                 device: torch.device | str = "cuda"):
        with open_gallery_readonly(path) as f:
            features = {t: f[t][:] for t in EXPORT_FEATURES if t in f}
            labels = {level: [x.decode() for x in f[f"{level}_list"][:]] for level in LEVELS}
        if not features:
            raise ValueError(f"{path} contains no encoded_*_feature datasets")
        self._setup(features, labels, max_k, dtype, rerank_oversample, selector, device, mesh)

    @classmethod
    def from_arrays(cls, features: Dict[str, np.ndarray], labels: Dict[str, List[str]],
                    max_k: int = 16, dtype: str = "float32", rerank_oversample: int = 4,
                    selector: str = "auto", device: torch.device | str = "cuda",
                    mesh=None) -> "KeySet":
        """The gallery from arrays in memory: features {encoded_*_feature:
        [N, D]} (None entries skipped), labels {level: [N names]}.  The
        arrays are copied."""
        features = {t: np.array(v, np.float32) for t, v in features.items() if v is not None}
        if not features:
            raise ValueError("no encoded_*_feature arrays given")
        ks = cls.__new__(cls)
        ks._setup(features, {level: list(labels[level]) for level in LEVELS}, max_k, dtype,
                  rerank_oversample, selector, device, mesh)
        return ks

    def _setup(self, features, labels, max_k, dtype, rerank_oversample, selector, device,
               mesh=None):
        if selector not in ("auto", "exact", "approx"):
            raise ValueError(f"selector must be auto/exact/approx, got {selector!r}")
        self.dtype = dtype
        self.device = torch.device(device)
        self.mesh = mesh
        if dtype == "int8":
            self.rerank_oversample = rerank_oversample
            self.selector = (("approx" if rerank_oversample else "exact")
                             if selector == "auto" else selector)
        else:
            self.selector = "exact" if selector == "auto" else selector
            self.rerank_oversample = rerank_oversample if self.selector == "approx" else 0
        self.features: Dict[str, object] = {}
        self._host_fp32: Dict[str, np.ndarray] = {}
        for t, rows in features.items():
            self.features[t] = prepare_keys(rows, device=self.device, dtype=dtype, mesh=mesh)
            if self.rerank_oversample:
                self._host_fp32[t] = np.asarray(rows, np.float32)
        self.labels = labels
        self.n = len(labels["species"])
        self.max_k = min(max_k, self.n)
        # one fixed device search width; the re-rank widens it by the oversample
        self._device_k = min(self.max_k * max(self.rerank_oversample, 1), self.n)

    def warm(self) -> None:
        """Run the search once per modality (query batch 1, the fixed device
        k), so that no client request pays the first product's set-up."""
        for key_type, mat in self.features.items():
            dim = (mat.dim if isinstance(mat, ShardedKeys) else
                   mat.q.shape[1] if isinstance(mat, QuantizedKeys) else mat.shape[1])
            self.search(np.zeros((1, dim), np.float32), key_type, k=1)

    def search(self, queries: np.ndarray, key_type: str, k: int):
        if key_type not in self.features:
            raise KeyError(f"key set has no {key_type} (available: {sorted(self.features)})")
        k = min(max(int(k), 1), self.max_k)
        sims, idx = knn_search(queries, self.features[key_type], k=self._device_k,
                               keys_normalized=True, mesh=self.mesh, shard="keys",
                               n_valid_keys=self.n, selector=self.selector, device=self.device)
        if self.rerank_oversample:
            sims, idx = rerank_candidates(queries, idx, self._host_fp32[key_type], k=self.max_k)
        return sims[:, :k], idx[:, :k]


class InferenceService:
    """Resident model + micro-batching executor (see module docstring).

    model: the port's `CLIBD` module, moved to `device` (the card unless the
    caller asks for the CPU).  keys_mesh: devices to shard the gallery over
    (`KeySet(mesh=)`)."""

    def __init__(
        self,
        model,
        model_cfg,
        keys_path: Optional[str] = None,
        buckets=(1, 2, 4, 8, 16, 32),
        window_ms: float = 4.0,
        max_batch: Optional[int] = None,
        image_size: int = 224,
        resize_to: int = 256,
        keys_mesh=None,
        keys_dtype: str = "float32",
        keys_rerank: int = 4,
        keys_selector: str = "auto",
        language_vocab: Optional[str] = None,
        text_max_len: int = 20,
        max_queue: int = 1024,
        device: torch.device | str = "cuda",
    ):
        from ..models.clibd import clibd_apply

        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.mc = model_cfg
        self.image_size = image_size
        self.resize_to = resize_to
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch or max(buckets)
        # buckets must reach max_batch: _drain can hand _execute up to
        # max_batch rows, and a batch larger than the largest bucket would
        # overflow the padded array
        self.buckets = tuple(sorted({b for b in buckets if b <= self.max_batch}
                                    | {self.max_batch}))
        self.stats = ServeStats()
        self._keys_cfg = {"dtype": keys_dtype, "rerank_oversample": keys_rerank,
                          "selector": keys_selector, "device": self.device, "mesh": keys_mesh}
        self.keys_path = keys_path
        self.reloads = 0
        self._reload_lock = threading.Lock()
        self.keys = KeySet(keys_path, **self._keys_cfg) if keys_path else None
        self.text_max_len = text_max_len
        self.has_image = model.image_encoder is not None or model.clip_vision is not None
        self.has_dna = model.dna_encoder is not None
        self._tok = None
        if language_vocab:
            from ..data.tokenizers import WordPieceTokenizer

            self._tok = WordPieceTokenizer(language_vocab)
        # open_clip-backbone checkpoints tokenize text with CLIP BPE (the
        # batch pipeline's own dispatch), from the config's clip.bpe_path
        self._clip_tok = None
        if model.clip_text is not None:
            from ..data.pipeline import BatchSpec

            self._clip_tok = BatchSpec.maybe_clip_tokenizer(model_cfg)

        def forward(modality):
            def fn(x) -> np.ndarray:
                # inference_mode is thread-local: entered here, on the
                # batcher's or pre_warm's own thread
                with torch.inference_mode():
                    x = to_device(x, self.device)
                    out = clibd_apply(self.model, self.mc, **{f"{modality}_input": x})[modality]
                    return out.float().cpu().numpy()

            return fn

        self._apply = {m: forward(m) for m in ("image", "dna", "language")}
        self.max_queue = max_queue
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._batcher = threading.Thread(target=self._run_batcher, name="clibd-serve-batcher",
                                         daemon=True)
        self._batcher.start()

    @property
    def serves_text(self) -> bool:
        return (self._clip_tok is not None
                or (self.model.language_encoder is not None and self._tok is not None))

    def reload_keys(self, path: Optional[str] = None) -> dict:
        """Hot-swap the retrieval gallery without restarting the server.

        Production galleries grow (the reference streams new records into
        an appendable backend HDF5); restarting would pay the checkpoint
        load and the warm-up again.  The new KeySet is built and warmed
        before an atomic attribute swap (in-flight searches keep the old
        object; a failed load leaves the old gallery serving).
        → summary dict for the HTTP response."""
        path = path or self.keys_path
        if path is None:
            raise ValueError("no gallery path: server was started without "
                             "--keys and the reload request named none")
        # serialise concurrent reloads (POST /reload racing the watcher)
        with self._reload_lock:
            new_keys = KeySet(path, **self._keys_cfg)
            new_keys.warm()
            old_n = self.keys.n if self.keys else 0
            self.keys = new_keys      # atomic swap (GIL attribute store)
            self.keys_path = path
            self.reloads += 1
            return {"keys": new_keys.n, "previous": old_n, "path": path,
                    "modalities": sorted(new_keys.features), "reloads": self.reloads}

    def start_reload_watch(self, interval_s: float) -> None:
        """Auto-reload the gallery when its file changes (`--reload-watch`):
        the gallery is reloaded only after its (mtime, size) signature holds
        stable for two consecutive polls (a mid-append HDF5 must not be
        loaded torn), and a failed load is retried next tick with the old
        gallery still serving."""
        if self.keys_path is None:
            raise ValueError("reload-watch needs a gallery (--keys)")
        self.stop_reload_watch()  # idempotent: never leak a second watcher
        self._watch_stop = threading.Event()
        # the baseline signature is taken here, synchronously: a write
        # landing before the thread's first poll must still be detected
        baseline = self._gallery_sig()
        self._watcher = threading.Thread(
            target=self._run_watcher, args=(float(interval_s), baseline),
            name="clibd-serve-watcher", daemon=True)
        self._watcher.start()

    def stop_reload_watch(self) -> None:
        if getattr(self, "_watcher", None) is not None:
            self._watch_stop.set()
            self._watcher.join(timeout=10)
            self._watcher = None

    def _gallery_sig(self):
        try:
            st = os.stat(self.keys_path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None  # mid-replace/missing: treat as not-yet-stable

    def _run_watcher(self, interval_s: float, loaded) -> None:
        pending = None
        while not self._watch_stop.wait(interval_s):
            if self._closed.is_set():
                return
            cur = self._gallery_sig()
            if cur is None or cur == loaded:
                pending = None
                continue
            if cur != pending:      # changed again since last poll: still
                pending = cur       # being written, wait for stability
                continue
            try:
                out = self.reload_keys()
                # the pre-load signature is what was loaded: an append during
                # the load is still seen, and reloaded, next tick
                loaded, pending = cur, None
                print(f"reload-watch: gallery -> {out['keys']} keys", flush=True)
            except Exception as e:  # noqa: BLE001 (torn read mid-append or a
                # transient FS error: the old gallery serves, retry next tick)
                print(f"reload-watch: load failed, retrying ({e})", flush=True)

    # -- host-side request preprocessing (caller's thread) ------------------

    def preprocess_image(self, image_bytes: bytes) -> np.ndarray:
        """The checkpoint's eval transform (with the long-edge
        `transform_with_resize` variant): queries are preprocessed exactly
        like the gallery the keys were extracted with."""
        from ..data.pipeline import preprocess_single_image

        return preprocess_single_image(self.mc, image_bytes, image_size=self.image_size,
                                       resize_to=self.resize_to)

    def preprocess_dna(self, barcode: str):
        """One barcode through the checkpoint's configured tokenizer (the
        extract pipeline's dispatch; an overlap-trained checkpoint served
        with the k-mer layout would return wrong embeddings)."""
        from ..data.pipeline import tokenize_single_barcode

        return tokenize_single_barcode(self.mc, barcode)

    def preprocess_text(self, text: str) -> Dict[str, np.ndarray]:
        """Taxonomy string → token dict, through the checkpoint's own text
        tokenizer: CLIP BPE for open_clip-backbone checkpoints, WordPiece
        otherwise (the layout the HDF5 builders pre-tokenize)."""
        if self._clip_tok is not None:
            ids = np.asarray(self._clip_tok([text]), np.int32)[0]
            return {"input_ids": ids}
        toks = self._tok.encode_batch([text], max_length=self.text_max_len)
        return {k: np.asarray(v[0]) for k, v in toks.items()}

    # -- public API ----------------------------------------------------------

    def embed(self, image_bytes: Optional[bytes] = None, dna: Optional[str] = None,
              text: Optional[str] = None, timeout: float = 60.0) -> dict:
        """Embed one record (any subset of modalities). Thread-safe; blocks
        until the micro-batch holding this request completes."""
        if image_bytes is None and dna is None and text is None:
            raise ValueError("provide image bytes, a DNA barcode, and/or a taxonomy text")
        # modality support and decodability are checked here, on the
        # caller's thread: a failure inside the batcher would fail every
        # co-batched request with it
        if image_bytes is not None and not self.has_image:
            raise ValueError("this checkpoint has no image encoder")
        if dna is not None and not self.has_dna:
            raise ValueError("this checkpoint has no DNA encoder")
        if text is not None:
            if self.model.clip_text is not None:
                if self._clip_tok is None:
                    raise ValueError(
                        "this open_clip text tower needs the CLIP BPE tokenizer: set "
                        "clip.bpe_path in the experiment config (as the train/extract "
                        "pipeline does)")
            elif self.model.language_encoder is not None:
                if self._tok is None:
                    raise ValueError("text queries need a WordPiece vocab (serve --language-vocab)")
            else:
                raise ValueError("this checkpoint has no language encoder")
        # load shedding: a bounded backlog keeps tail latency honest (fail
        # fast, HTTP 503); qsize() is approximate, which is fine for shedding
        if self._queue.qsize() >= self.max_queue:
            self.stats.record_error()
            raise Overloaded(f"server overloaded ({self.max_queue} requests queued)")
        # a put() after close() drained the queue would block this caller for
        # its whole timeout: shed instead
        if self._closed.is_set():
            raise RuntimeError("server shutting down")
        t0 = time.perf_counter()
        item = {"future": Future()}
        if image_bytes is not None:
            try:
                item["image"] = self.preprocess_image(image_bytes)
            except Exception as e:
                raise ValueError(f"undecodable image: {e}") from e
        if dna is not None:
            item["dna"] = self.preprocess_dna(dna)
        if text is not None:
            item["language"] = self.preprocess_text(text)
        self._queue.put(item)
        out = item["future"].result(timeout=timeout)
        self.stats.record_request((time.perf_counter() - t0) * 1e3)
        return out

    def search(self, image_bytes: Optional[bytes] = None, dna: Optional[str] = None,
               text: Optional[str] = None, k: int = 5, against: Optional[str] = None,
               timeout: float = 60.0) -> dict:
        """Embed + top-k against the preloaded key set.  `against` picks the
        gallery feature ('image'/'dna'/'language'); default is the query's
        own modality (cross-modal search, e.g. an image query against DNA
        keys, via against='dna')."""
        # snapshot once: a concurrent /reload swaps self.keys atomically, and
        # reading it twice could pair old-gallery indices with new labels
        keys = self.keys
        if keys is None:
            raise RuntimeError("no key set loaded (start with keys_path=...)")
        emb = self.embed(image_bytes=image_bytes, dna=dna, text=text, timeout=timeout)
        out = {}
        for modality in ("image", "dna", "language"):
            if emb.get(modality) is None:
                continue
            key_type = f"encoded_{against or modality}_feature"
            sims, idx = keys.search(emb[modality][None, :], key_type, k)
            out[modality] = {
                "key_type": key_type,
                "scores": sims[0].tolist(),
                "predictions": [{level: keys.labels[level][j] for level in LEVELS}
                                for j in idx[0].tolist()],
            }
        out["embeddings"] = {m: v.tolist() for m, v in emb.items() if v is not None}
        return out

    def pre_warm(self) -> None:
        """Run every (modality, bucket) forward once before accepting
        traffic: the first call builds the kernels and cuBLAS picks its
        algorithms per shape.  Each output is copied to the host, which
        waits for the card."""
        for b in self.buckets:
            if self.has_image:
                s = self.image_size  # eval_transform yields HWC float32
                self._apply["image"](np.zeros((b, s, s, 3), np.float32))
            if self.has_dna:
                d0 = self.preprocess_dna("A" * 10)
                if isinstance(d0, dict):  # overlap tokenizer → token dict
                    d = {k: np.zeros((b,) + v.shape, v.dtype) for k, v in d0.items()}
                else:
                    d = np.zeros((b,) + d0.shape, d0.dtype)
                self._apply["dna"](d)
            if self.serves_text:
                t = self.preprocess_text("warm up")
                self._apply["language"]({k: np.zeros((b,) + v.shape, v.dtype)
                                         for k, v in t.items()})
        if self.keys is not None:
            self.keys.warm()

    def close(self) -> None:
        self._closed.set()
        self.stop_reload_watch()
        self._queue.put(None)  # wake the batcher
        self._batcher.join(timeout=10)
        # fail whatever the batcher did not get to: otherwise those callers
        # block in future.result() until their timeout
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item["future"].done():
                item["future"].set_exception(RuntimeError("server shutting down"))

    # -- batcher -------------------------------------------------------------

    def _drain(self, first) -> list:
        """first request + everything arriving within window_ms, ≤ max_batch."""
        items = [first]
        deadline = time.monotonic() + self.window_s
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run_batcher(self) -> None:
        while not self._closed.is_set():
            first = self._queue.get()
            if first is None:
                continue
            items = self._drain(first)
            try:
                self._execute(items)
            except Exception as e:  # resolve futures so callers don't hang
                self.stats.record_error()
                for it in items:
                    if not it["future"].done():
                        it["future"].set_exception(e)

    @staticmethod
    def _pad_stack(rows, b):
        """[(i, arr-or-dict)] → padded batch of bucket size b (dicts are
        padded per field: the language tokenizer emits a token dict)."""
        first = rows[0][1]
        if isinstance(first, dict):
            return {k: InferenceService._pad_stack([(i, d[k]) for i, d in rows], b)
                    for k in first}
        x = np.zeros((b,) + first.shape, first.dtype)
        for j, (_, arr) in enumerate(rows):
            x[j] = arr
        return x

    def _execute(self, items: list) -> None:
        self.stats.record_batch(len(items))
        results = [dict() for _ in items]
        for modality in ("image", "dna", "language"):
            rows = [(i, it[modality]) for i, it in enumerate(items) if modality in it]
            if not rows:
                continue
            out = self._apply[modality](self._pad_stack(rows, _next_bucket(len(rows),
                                                                           self.buckets)))
            for j, (i, _) in enumerate(rows):
                results[i][modality] = out[j]
        for it, res in zip(items, results):
            for modality in ("image", "dna", "language"):
                res.setdefault(modality, None)
            it["future"].set_result(res)


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


def make_server(service: InferenceService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """HTTP front end:

    - GET  /healthz               → {"status": "ok", "keys": N|null}
    - GET  /stats                 → ServeStats snapshot
    - GET  /metrics               → the same as Prometheus text
    - POST /embed  {"image_b64"?, "dna"?, "text"?}   → embeddings
    - POST /search {"image_b64"?, "dna"?, "text"?, "k"?, "against"?}
                                  → top-k taxonomy per query modality
    - POST /reload {"keys"?}      → hot-swap the gallery
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                batcher_up = service._batcher.is_alive()
                self._send(200 if batcher_up else 503,
                           {"status": "ok" if batcher_up else "batcher dead",
                            "keys": service.keys.n if service.keys else None,
                            "buckets": list(service.buckets),
                            "reloads": service.reloads})
            elif self.path == "/stats":
                self._send(200, service.stats.snapshot())
            elif self.path == "/metrics":
                # Prometheus text exposition (/stats is the JSON twin);
                # counters are cumulative since process start
                s = service.stats.snapshot()
                lines = [
                    "# TYPE clibd_requests_total counter",
                    f"clibd_requests_total {s['requests']}",
                    "# TYPE clibd_request_errors_total counter",
                    f"clibd_request_errors_total {s['errors']}",
                    "# TYPE clibd_device_batches_total counter",
                    f"clibd_device_batches_total {s['batches']}",
                    "# TYPE clibd_gallery_reloads_total counter",
                    f"clibd_gallery_reloads_total {service.reloads}",
                    "# TYPE clibd_gallery_keys gauge",
                    f"clibd_gallery_keys {service.keys.n if service.keys else 0}",
                    "# TYPE clibd_batcher_up gauge",
                    f"clibd_batcher_up {int(service._batcher.is_alive())}",
                ]
                for name, v in (("clibd_mean_batch_size", s["mean_batch_size"]),
                                ("clibd_latency_p50_ms", s["p50_ms"]),
                                ("clibd_latency_p95_ms", s["p95_ms"])):
                    if v is not None:
                        lines += [f"# TYPE {name} gauge", f"{name} {v}"]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path not in ("/embed", "/search", "/reload"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    self._send(400, {"error": "body must be a JSON object"})
                    return
                if self.path == "/reload":
                    # admin surface (the bind address is the access control:
                    # the server defaults to loopback)
                    keys_arg = req.get("keys")
                    if keys_arg is not None and not isinstance(keys_arg, str):
                        self._send(400, {"error": "keys must be a string path"})
                        return
                    try:
                        out = service.reload_keys(keys_arg)
                    except OSError as e:
                        # a missing/unreadable gallery is a client error, and
                        # the old gallery keeps serving
                        service.stats.record_error()
                        self._send(400, {"error": str(e)})
                        return
                    self._send(200, out)
                    return
                for name in ("image_b64", "dna", "text"):
                    if req.get(name) is not None and not isinstance(req[name], str):
                        self._send(400, {"error": f"{name} must be a string"})
                        return
                image_bytes = None
                if req.get("image_b64"):
                    image_bytes = base64.b64decode(req["image_b64"], validate=True)
                dna = req.get("dna")
                text = req.get("text")
                if image_bytes is None and dna is None and text is None:
                    self._send(400, {"error": "provide image_b64, dna, and/or text"})
                    return
                if self.path == "/embed":
                    out = service.embed(image_bytes=image_bytes, dna=dna, text=text)
                    self._send(200, {m: (v.tolist() if v is not None else None)
                                     for m, v in out.items()})
                else:
                    out = service.search(image_bytes=image_bytes, dna=dna, text=text,
                                         k=int(req.get("k", 5)), against=req.get("against"))
                    self._send(200, out)
            except Overloaded as e:
                # embed() already counted the shed in stats
                self._send(503, {"error": str(e)})
            except (ValueError, KeyError, binascii.Error, json.JSONDecodeError) as e:
                service.stats.record_error()
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 (a failed request must never
                # drop the connection without a response; the stack goes to
                # the server log)
                import traceback

                traceback.print_exc()
                service.stats.record_error()
                code = 503 if isinstance(e, RuntimeError) else 500
                self._send(code, {"error": f"{type(e).__name__}: {e}"})

    return _Server((host, port), Handler)


class _Server(ThreadingHTTPServer):
    # the listen backlog: the stdlib's 5 resets connections of a burst of
    # concurrent clients, the very traffic the batcher coalesces
    request_queue_size = 256
