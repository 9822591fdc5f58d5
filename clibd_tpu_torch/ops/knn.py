"""kNN retrieval: the port of `clibd_tpu/ops/knn.py` (L2-normalised
inner-product search as a matmul plus top-k, the reference's FAISS
IndexFlatIP).

Scores over an fp32 gallery are an fp32 `torch.matmul` with TF32 off (the
package sets it at import; the counterpart of `Precision.HIGHEST`), and
selection is `top_k_lower_index_first`: `jax.lax.top_k`'s order, equal
scores lower key index first, which `torch.topk` does not promise.  Queries
go through in chunks of `query_chunk` rows, a Python loop in place of
`lax.map`, each padded with zero rows to a multiple of 8 so that identical
keys score identically (see `knn_search`).  These are large plain products
that the JAX package leaves to XLA, and the port leaves to cuBLAS.

The int8 gallery (`QuantizedKeys`, `prepare_keys(dtype="int8")`) holds each
L2-normalised key row as int8 with one fp32 scale, 4x smaller than fp32.
JAX scores it as dot(bf16(q), bf16(int8 keys)) with fp32 accumulation,
times the scale.  Here the query is rounded to bf16 and back, and the int8
keys are widened to fp32 `KEY_CHUNK` rows at a time (exact: int8 values and
bf16 queries are both exact in fp32, and so is each product), so only the
summation order differs from JAX; no fp32 copy of the whole gallery is ever
held.  `rerank_candidates` re-ranks an oversampled candidate set exactly
against the original fp32 rows on the host.

`selector="approx"` wraps `jax.lax.approx_max_k`, the TPU's partial-reduce
selection; it has no counterpart on the card and selects exactly here (on
the CPU JAX lowers it exactly too).

Over a list of local devices (`mesh=`: a `parallel.Mesh` or a list of
`torch.device`s, which may name one card twice; `clibd_tpu/ops/knn.py:
120-225`):

- shard="queries": the keys whole on every device, the queries split into
  one block a device; no merge is needed, and the result is the unsharded
  search's;
- shard="keys": 1/D of the gallery a device (`prepare_keys(mesh=)` pads
  the rows to a multiple of D and gives a `ShardedKeys`; the int8 gallery
  is sharded the same way), each device's pad rows set to -inf before its
  own top k, and the D*k candidates merged into the global top k on the
  first device.  Candidates lie in shard order and, within a shard, in
  `top_k_lower_index_first`'s order, so the merge keeps `jax.lax.top_k`'s
  order of equal scores: lower key index first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.clibd import l2_normalize

# int8 key rows widened to fp32 at a time: 64k x 768 fp32 is 192 MiB
KEY_CHUNK = 65536


class QuantizedKeys(NamedTuple):
    """int8 gallery (`clibd_tpu/ops/knn.py:27-42`): per-row symmetric
    quantisation of the L2-normalised keys, q = round(row / scale), scale =
    max|row| / 127."""

    q: torch.Tensor       # [N, D] int8
    scale: torch.Tensor   # [N] fp32 per-row dequantisation scale
    n_valid: int          # rows that are keys (rows past it are padding)


def quantize_keys(keys: np.ndarray, chunk: int = 262144) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side L2-normalise + per-row int8 quantisation, in chunks (copied
    from `clibd_tpu/ops/knn.py:44-61`) → (q int8 [N, D], scale fp32 [N]).
    As there, a float32 ndarray is normalised in place (its chunks are
    views), which the re-rank's host copy of the rows does not mind."""
    keys = np.asarray(keys)
    n = keys.shape[0]
    q = np.empty(keys.shape, np.int8)
    scale = np.empty((n,), np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = np.asarray(keys[lo:hi], np.float32)
        block /= np.maximum(np.linalg.norm(block, axis=1, keepdims=True), 1e-12)
        s = np.max(np.abs(block), axis=1) / 127.0
        s = np.maximum(s, 1e-12)
        q[lo:hi] = np.round(block / s[:, None]).astype(np.int8)
        scale[lo:hi] = s
    return q, scale


class ShardedKeys(NamedTuple):
    """A gallery split by rows over devices (`prepare_keys(mesh=)`): shard d
    holds rows [d * R, (d + 1) * R) on its device, an fp32 tensor or a
    `QuantizedKeys`; rows from n_valid on are zero padding."""

    shards: tuple
    n_valid: int

    @property
    def dim(self) -> int:
        first = self.shards[0]
        return (first.q if isinstance(first, QuantizedKeys) else first).shape[1]


def _mesh_devices(mesh) -> list:
    """The devices of a `parallel.Mesh` or of a list of devices."""
    devices = getattr(mesh, "devices", mesh)
    return [torch.device(d) for d in devices]


def _split_rows(x: np.ndarray, n_shards: int) -> list:
    """x padded with zero rows to a multiple of n_shards, in n_shards blocks."""
    pad = (-x.shape[0]) % n_shards
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return np.split(x, n_shards)


def _shard_rows(keys, devices: list) -> "ShardedKeys":
    """An fp32 key matrix or a `QuantizedKeys` split by rows over `devices`
    as it stands (no normalisation), zero rows padding the last shard."""
    n = len(devices)
    if isinstance(keys, QuantizedKeys):
        q = torch.as_tensor(keys.q).cpu().numpy()
        scale = torch.as_tensor(keys.scale).cpu().numpy()
        return ShardedKeys(tuple(
            QuantizedKeys(torch.from_numpy(qs).to(d), torch.from_numpy(ss).to(d), qs.shape[0])
            for qs, ss, d in zip(_split_rows(q, n), _split_rows(scale, n), devices)),
            keys.n_valid)
    keys = (keys.detach().cpu().numpy() if isinstance(keys, torch.Tensor)
            else np.asarray(keys, np.float32))
    return ShardedKeys(tuple(torch.from_numpy(part).to(d) for part, d in
                             zip(_split_rows(keys, n), devices)), keys.shape[0])


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def prepare_keys(keys, device: torch.device | str = "cuda", dtype: str = "float32", mesh=None):
    """Upload and L2-normalise a key matrix once, for reuse across the eval
    grid → an fp32 tensor; dtype="int8": a `QuantizedKeys` gallery (int8
    rows and fp32 scales on `device`), which `knn_search` takes wherever a
    key matrix goes.  mesh (more than one device): a `ShardedKeys` over its
    devices, the rows padded to a multiple of their number, for
    `knn_search(shard="keys")`; `device` is then unused."""
    if dtype not in ("float32", "int8"):
        raise ValueError(f"dtype must be 'float32' or 'int8', got {dtype!r}")
    devices = _mesh_devices(mesh) if mesh is not None else [torch.device(device)]
    if len(devices) == 1:
        device = devices[0]
    if dtype == "int8":
        if isinstance(keys, torch.Tensor):
            keys = keys.detach().cpu().numpy().copy()  # leave the caller's tensor as it is
        q, scale = quantize_keys(keys)
        if len(devices) > 1:
            return _shard_rows(QuantizedKeys(q, scale, q.shape[0]), devices)
        return QuantizedKeys(torch.from_numpy(q).to(device), torch.from_numpy(scale).to(device),
                             q.shape[0])
    if len(devices) > 1:
        sharded = _shard_rows(keys, devices)
        return ShardedKeys(tuple(l2_normalize(s) for s in sharded.shards), sharded.n_valid)
    return l2_normalize(_as_tensor(keys, device))


def top_k_lower_index_first(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top k of `scores` [R, K] as `jax.lax.top_k` selects them: the
    k largest, sorted by score descending and, among equal scores, by key
    index ascending → (values [R, k], indices [R, k] int64).

    No row is sorted whole: `torch.topk` gives the k-th score, every key
    above it is kept, and of the keys tied with it the lowest-indexed ones
    fill the rest (a running count over the row's tie mask, taken only in
    rows with more ties than places); then the k survivors are ordered."""
    kth = torch.topk(scores, k, dim=1).values[:, -1:]
    keep = scores >= kth
    surplus = (keep.sum(dim=1) > k).nonzero()[:, 0]
    if surplus.numel():
        s, t = scores[surplus], kth[surplus]
        above = s > t
        tied = s == t
        places = k - above.sum(dim=1, keepdim=True)
        keep[surplus] = above | (tied & (tied.cumsum(dim=1, dtype=torch.int32) <= places))
    idx = keep.nonzero()[:, 1].view(-1, k)  # ascending within each row
    vals = scores.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def _scores(q: torch.Tensor, keys: torch.Tensor, scale) -> torch.Tensor:
    """One query chunk's scores [rows, N] fp32: an fp32 product for fp32
    keys; for int8 keys the bf16-rounded query against `KEY_CHUNK` key rows
    at a time widened to fp32, times their scales, written into one buffer
    (so that selection runs once over the whole row)."""
    if scale is None:
        return torch.matmul(q, keys.T)
    q = q.to(torch.bfloat16).float()
    out = q.new_empty(q.shape[0], keys.shape[0])
    for lo in range(0, keys.shape[0], KEY_CHUNK):
        hi = lo + KEY_CHUNK
        out[:, lo:hi] = torch.matmul(q, keys[lo:hi].float().T) * scale[lo:hi]
    return out


def _search_chunks(queries: torch.Tensor, keys: torch.Tensor, scale, k: int, query_chunk: int,
                   valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k of each query row against one key matrix, query_chunk rows at
    a time; valid [N] bool: keys outside it score -inf."""
    sims, idx = [], []
    for lo in range(0, queries.shape[0], query_chunk):
        q = queries[lo:lo + query_chunk]
        rows = q.shape[0]
        # zero rows up to a multiple of 8: a one-row chunk would take BLAS's
        # matrix-vector path, which scores identical keys a last bit apart by
        # their position, and an exact tie would no longer be one (the
        # reference pads every chunk to query_chunk rows)
        q = torch.cat([q, q.new_zeros((-rows) % 8, q.shape[1])])
        scores = _scores(q, keys, scale)[:rows]
        if valid is not None:
            scores = scores.masked_fill(~valid, float("-inf"))
        s, i = top_k_lower_index_first(scores, k)
        sims.append(s)
        idx.append(i)
    if not sims:
        return (queries.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int64, device=queries.device))
    return torch.cat(sims), torch.cat(idx)


def _unpack(keys, device):
    """(keys, scale or None) of one key matrix or `QuantizedKeys` on
    `device`."""
    if isinstance(keys, QuantizedKeys):
        return torch.as_tensor(keys.q).to(device), _as_tensor(keys.scale, device)
    return _as_tensor(keys, device), None


def _gather_shards(keys: ShardedKeys, device) -> Tuple[torch.Tensor, object]:
    """The shards on one device, as one matrix (and scale)."""
    parts = [_unpack(s, device) for s in keys.shards]
    scale = None if parts[0][1] is None else torch.cat([p[1] for p in parts])
    return torch.cat([p[0] for p in parts]), scale


def knn_search(queries, keys, k: int = 5, query_chunk: int = 4096, normalize: bool = True,
               keys_normalized: bool = False, selector: str = "exact", mesh=None,
               shard: str = "queries", n_valid_keys: int = None,
               device: torch.device | str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """→ (similarities [N, k] fp32, indices [N, k] int64), sorted descending.

    Runs where a tensor input lies (keys first, then queries); numpy inputs
    go to `device`, the card unless the caller asks for the CPU.
    keys_normalized=True: keys came from prepare_keys.  keys may be a
    `QuantizedKeys` (approximate scores; see the module docstring).
    n_valid_keys: only the first n_valid_keys rows are keys (default: all,
    or a `QuantizedKeys`' or `ShardedKeys`' n_valid).  selector="approx"
    selects exactly (the TPU's approx_max_k has no counterpart here).

    mesh (a `parallel.Mesh` or a list of devices) with more than one
    device: shard="queries" searches a block of queries on each device
    against the whole gallery; shard="keys" searches each device's rows of
    a `ShardedKeys` (a plain matrix is split first) and merges the
    candidates on the first device.  A shard of fewer than k rows is
    searched whole on the first device, as the JAX package does."""
    if shard not in ("queries", "keys"):
        raise ValueError(f"shard must be 'queries' or 'keys', got {shard!r}")
    if selector not in ("exact", "approx"):
        raise ValueError(f"selector must be 'exact' or 'approx', got {selector!r}")
    devices = _mesh_devices(mesh) if mesh is not None else []
    sharded = isinstance(keys, ShardedKeys)
    if sharded or (len(devices) > 1 and shard == "keys"):
        if not sharded:
            keys = _shard_rows(keys, devices)
        return _knn_keys_sharded(queries, keys, k, query_chunk, normalize, keys_normalized,
                                 n_valid_keys)
    if isinstance(keys, QuantizedKeys):
        keys_normalized = True  # quantised after normalisation
        if n_valid_keys is None:
            n_valid_keys = keys.n_valid
    tensors = [x for x in ((keys.q if isinstance(keys, QuantizedKeys) else keys), queries)
               if isinstance(x, torch.Tensor)]
    home = tensors[0].device if tensors else torch.device(device)
    queries = _as_tensor(queries, home)
    if normalize:
        queries = l2_normalize(queries)
    query_chunk = int(max(1, query_chunk))
    if len(devices) > 1:  # shard="queries"
        blocks = queries.tensor_split(len(devices))
        outs = [_knn_one(b.to(d), keys, k, query_chunk, normalize, keys_normalized,
                         n_valid_keys, d) for b, d in zip(blocks, devices)]
        sims = torch.cat([o[0].to(home) for o in outs])
        idx = torch.cat([o[1].to(home) for o in outs])
    else:
        sims, idx = _knn_one(queries, keys, k, query_chunk, normalize, keys_normalized,
                             n_valid_keys, home)
    return sims.cpu().numpy(), idx.cpu().numpy()


def _knn_one(queries: torch.Tensor, keys, k: int, query_chunk: int, normalize: bool,
             keys_normalized: bool, n_valid_keys, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search of (already normalised) queries against one whole gallery
    on `device`."""
    keys, scale = _unpack(keys, device)
    n_valid = int(n_valid_keys if n_valid_keys is not None else keys.shape[0])
    keys = keys[:n_valid]
    if scale is not None:
        scale = scale[:n_valid]
    elif normalize and not keys_normalized:
        keys = l2_normalize(keys)
    return _search_chunks(queries, keys, scale, int(min(k, n_valid)), query_chunk)


def _knn_keys_sharded(queries, keys: ShardedKeys, k: int, query_chunk: int, normalize: bool,
                      keys_normalized: bool, n_valid_keys) -> Tuple[np.ndarray, np.ndarray]:
    """Key-sharded search (`clibd_tpu/ops/knn.py:164-225`): each shard's top
    k with its pad rows at -inf, then the exact top k of the D*k
    candidates on the first shard's device."""
    quantized = isinstance(keys.shards[0], QuantizedKeys)
    n_valid = int(n_valid_keys if n_valid_keys is not None else keys.n_valid)
    home = (keys.shards[0].q if quantized else keys.shards[0]).device
    queries = _as_tensor(queries, home)
    if normalize:
        queries = l2_normalize(queries)
    normalize_keys = normalize and not keys_normalized and not quantized
    k = int(min(k, n_valid))
    query_chunk = int(max(1, query_chunk))
    rows = (keys.shards[0].q if quantized else keys.shards[0]).shape[0]
    if rows < k:  # a shard smaller than k: search the gallery whole
        whole, scale = _gather_shards(keys, home)
        whole = whole[:n_valid]
        if scale is not None:
            scale = scale[:n_valid]
        elif normalize_keys:
            whole = l2_normalize(whole)
        sims, idx = _search_chunks(queries, whole, scale, k, query_chunk)
        return sims.cpu().numpy(), idx.cpu().numpy()
    cand_sims, cand_idx = [], []
    for d, part in enumerate(keys.shards):
        shard_keys, scale = _unpack(part, (part.q if quantized else part).device)
        if normalize_keys:
            shard_keys = l2_normalize(shard_keys)
        offset = d * rows
        valid = (offset + torch.arange(rows, device=shard_keys.device)) < n_valid
        s, i = _search_chunks(queries.to(shard_keys.device), shard_keys, scale, k, query_chunk,
                              valid)
        cand_sims.append(s.to(home))
        cand_idx.append((i + offset).to(home))
    sims_all, idx_all = torch.cat(cand_sims, dim=1), torch.cat(cand_idx, dim=1)
    top, pos = top_k_lower_index_first(sims_all, k)
    return top.cpu().numpy(), idx_all.gather(1, pos).cpu().numpy()


def rerank_candidates(queries: np.ndarray, cand_idx: np.ndarray, keys_fp32, k: int,
                      normalize_queries: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host-side re-rank of an oversampled candidate set (copied from
    `clibd_tpu/ops/knn.py:359-388`): search the int8 gallery at k *
    oversample, then score those candidates against the original fp32 rows
    here.  queries [N, D]; cand_idx [N, M] from knn_search; keys_fp32 the
    original key matrix (unnormalised is fine), h5py dataset or ndarray.
    → (sims [N, k], idx [N, k]) exact, sorted descending."""
    queries = np.asarray(queries, np.float32)
    if normalize_queries:
        queries = queries / np.maximum(
            np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    cand_idx = np.asarray(cand_idx)
    uniq, inv = np.unique(cand_idx, return_inverse=True)
    rows = np.asarray(keys_fp32[uniq] if isinstance(keys_fp32, np.ndarray)
                      else keys_fp32[list(uniq)], np.float32)
    rows /= np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
    gathered = rows[inv.reshape(cand_idx.shape)]        # [N, M, D]
    scores = np.einsum("nd,nmd->nm", queries, gathered)  # exact fp32
    k = min(k, cand_idx.shape[1])
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(scores, order, axis=1),
            np.take_along_axis(cand_idx, order, axis=1))


def find_k_closest_records(query_feature, keys_feature, key_file_names, k: int = 5,
                           query_chunk: int = 4096, device: torch.device | str = "cuda"):
    """File-name lookups (reference util/util.py:224-234): raw inner product,
    not cosine, as the reference feeds raw features to IndexFlatIP here.
    → (names [N, k] object array, similarities).  Runs as `knn_search`."""
    sims, indices = knn_search(query_feature, keys_feature, k=k, query_chunk=query_chunk,
                               normalize=False, device=device)
    names = np.asarray(key_file_names, dtype=object)[indices]
    return names, sims


def make_prediction(query_feature, keys_feature, keys_label, with_similarity: bool = False,
                    with_indices: bool = False, max_k: int = 5, query_chunk: int = 4096,
                    device: torch.device | str = "cuda"):
    """Per-query {level: [k labels]} dicts (reference util/util.py:521-553),
    optionally with similarities / indices.  Runs as `knn_search`."""
    sims, indices = knn_search(query_feature, keys_feature, k=max_k, query_chunk=query_chunk,
                               device=device)
    levels = ("order", "family", "genus", "species")
    pred_list = [{level: [keys_label[i][level] for i in row] for level in levels}
                 for row in indices]
    out = [pred_list]
    if with_similarity:
        out.append(sims)
    if with_indices:
        out.append(indices)
    return out[0] if len(out) == 1 else out
