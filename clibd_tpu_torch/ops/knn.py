"""Exact kNN retrieval: the port of the exact fp32 path of
`clibd_tpu/ops/knn.py` (L2-normalised inner-product search as a matmul plus
top-k, the reference's FAISS IndexFlatIP).

Scores are an fp32 `torch.matmul` with TF32 off (the package sets it at
import; the counterpart of `Precision.HIGHEST`), and selection is
`top_k_lower_index_first`: `jax.lax.top_k`'s order, equal scores lower key
index first, which `torch.topk` does not promise.  Queries go through in
chunks of `query_chunk` rows, a Python loop in place of `lax.map`, each
padded with zero rows to a multiple of 8 so that identical keys score
identically (see `knn_search`).  These are large plain products that the
JAX package leaves to XLA, and the port leaves to cuBLAS.

Not ported yet: the int8 `QuantizedKeys` gallery, `selector="approx"`, the
query- and key-sharded multi-device searches and `rerank_candidates`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.clibd import l2_normalize

_LATER = "is not ported to clibd_tpu_torch yet (ROADMAP.md: int8/approx/sharded kNN)"


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def prepare_keys(keys, device: torch.device | str = "cuda", dtype: str = "float32") -> torch.Tensor:
    """Upload and L2-normalise a key matrix once, for reuse across the eval
    grid."""
    if dtype != "float32":
        raise NotImplementedError(f"prepare_keys dtype={dtype!r} {_LATER}")
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


def knn_search(queries, keys, k: int = 5, query_chunk: int = 4096, normalize: bool = True,
               keys_normalized: bool = False, selector: str = "exact",
               device: torch.device | str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """→ (similarities [N, k] fp32, indices [N, k] int64), sorted descending.

    Runs where a tensor input lies (keys first, then queries); numpy inputs
    go to `device`, the card unless the caller asks for the CPU.
    keys_normalized=True: keys came from prepare_keys."""
    if selector != "exact":
        raise NotImplementedError(f"selector={selector!r} {_LATER}")
    tensors = [x for x in (keys, queries) if isinstance(x, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device(device)
    queries = _as_tensor(queries, device)
    keys = _as_tensor(keys, device)
    if normalize:
        queries = l2_normalize(queries)
        if not keys_normalized:
            keys = l2_normalize(keys)
    k = int(min(k, keys.shape[0]))
    query_chunk = int(max(1, query_chunk))
    sims, idx = [], []
    for lo in range(0, queries.shape[0], query_chunk):
        q = queries[lo:lo + query_chunk]
        rows = q.shape[0]
        # zero rows up to a multiple of 8: a one-row chunk would take BLAS's
        # matrix-vector path, which scores identical keys a last bit apart by
        # their position, and an exact tie would no longer be one (the
        # reference pads every chunk to query_chunk rows)
        q = torch.cat([q, q.new_zeros((-rows) % 8, q.shape[1])])
        scores = torch.matmul(q, keys.T)[:rows]
        s, i = top_k_lower_index_first(scores, k)
        sims.append(s)
        idx.append(i)
    if not sims:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    return torch.cat(sims).cpu().numpy(), torch.cat(idx).cpu().numpy()


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
