"""The port's int8 kNN gallery, `selector="approx"` and the host re-rank
against clibd_tpu/ops/knn.py.  Every input comes from a numpy generator
seeded inside its test."""

import numpy as np
import pytest
import torch

from clibd_tpu.ops import knn as jax_knn
from clibd_tpu_torch.ops import knn as port_knn

SCORE_ATOL = 1e-5  # int8 scores: the same exact products, summed in another order


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,chunk", [(37, 16, 262144), (300, 64, 128), (5, 768, 2)])
def test_quantize_keys_bit_equal_to_jax(n, d, chunk):
    rng = np.random.default_rng(n + d)
    keys = rng.standard_normal((n, d)).astype(np.float32) * 3
    # each gets its own copy: both normalise a float32 array in place
    want_q, want_s = jax_knn.quantize_keys(keys.copy(), chunk=chunk)
    got_q, got_s = port_knn.quantize_keys(keys.copy(), chunk=chunk)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)


def test_prepare_keys_int8_holds_the_quantised_rows():
    rng = np.random.default_rng(3)
    keys = rng.standard_normal((40, 16)).astype(np.float32)
    qk = port_knn.prepare_keys(keys.copy(), device="cpu", dtype="int8")
    assert isinstance(qk, port_knn.QuantizedKeys) and qk.n_valid == 40
    assert qk.q.dtype == torch.int8 and qk.scale.dtype == torch.float32
    q, s = port_knn.quantize_keys(keys.copy())
    np.testing.assert_array_equal(qk.q.numpy(), q)
    np.testing.assert_array_equal(qk.scale.numpy(), s)
    with pytest.raises(ValueError, match="dtype"):
        port_knn.prepare_keys(keys.copy(), device="cpu", dtype="float16")


@pytest.mark.parametrize("n_keys,d,k,query_chunk", [(200, 32, 5, 4096), (1000, 64, 8, 7),
                                                    (77, 768, 3, 1)])
def test_int8_search_matches_jax(n_keys, d, k, query_chunk):
    """Scores within 1e-5 of JAX's; the indices equal wherever the scores
    around the k-th place are more than 1e-5 apart (closer ones may swap
    with the summation order)."""
    rng = np.random.default_rng(n_keys)
    keys = rng.standard_normal((n_keys, d)).astype(np.float32)
    queries = rng.standard_normal((19, d)).astype(np.float32)
    jax_keys = jax_knn.prepare_keys(keys.copy(), dtype="int8")
    port_keys = port_knn.prepare_keys(keys.copy(), device="cpu", dtype="int8")
    want_s, want_i = jax_knn.knn_search(queries, jax_keys, k=k + 1, query_chunk=query_chunk)
    got_s, got_i = port_knn.knn_search(queries, port_keys, k=k + 1, query_chunk=query_chunk)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=SCORE_ATOL)
    separated = (-np.diff(want_s, axis=1) > SCORE_ATOL).all(axis=1)
    assert separated.sum() >= len(queries) // 2
    np.testing.assert_array_equal(got_i[separated, :k], want_i[separated, :k])


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_small_key_chunks_equal_one_chunk_ties_included(k, monkeypatch):
    """Keys widened in chunks of 4 rows give what one chunk gives, bit for
    bit; with every key three times (keys i, i + 7, i + 14, so the copies
    lie in different chunks) the ties keep jax.lax.top_k's order, as JAX's
    own int8 search gives them."""
    rng = np.random.default_rng(60 + k)
    rows = rng.standard_normal((7, 16)).astype(np.float32)
    keys = np.concatenate([rows, rows, rows])
    queries = np.concatenate([rows[[0, 3, 6]], rng.standard_normal((4, 16)).astype(np.float32)])
    qk = port_knn.prepare_keys(keys.copy(), device="cpu", dtype="int8")
    one_s, one_i = port_knn.knn_search(queries, qk, k=k, query_chunk=3)
    monkeypatch.setattr(port_knn, "KEY_CHUNK", 4)
    got_s, got_i = port_knn.knn_search(queries, qk, k=k, query_chunk=3)
    np.testing.assert_array_equal(got_s, one_s)
    np.testing.assert_array_equal(got_i, one_i)
    jax_keys = jax_knn.prepare_keys(keys.copy(), dtype="int8")
    want_s, want_i = jax_knn.knn_search(queries, jax_keys, k=k, query_chunk=3)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=SCORE_ATOL)
    if k >= 3:
        assert got_i[:3, :3].tolist() == [[0, 7, 14], [3, 10, 17], [6, 13, 20]]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_approx_selector_equals_exact(dtype):
    """approx selects exactly in the port, as JAX's approx_max_k does on the
    CPU."""
    rng = np.random.default_rng(11)
    keys = rng.standard_normal((500, 32)).astype(np.float32)
    queries = rng.standard_normal((9, 32)).astype(np.float32)
    prepared = port_knn.prepare_keys(keys.copy(), device="cpu", dtype=dtype)
    ex_s, ex_i = port_knn.knn_search(queries, prepared, k=6, keys_normalized=True)
    ap_s, ap_i = port_knn.knn_search(queries, prepared, k=6, keys_normalized=True,
                                     selector="approx")
    np.testing.assert_array_equal(ap_i, ex_i)
    np.testing.assert_array_equal(ap_s, ex_s)
    jax_keys = jax_knn.prepare_keys(keys.copy(), dtype=dtype)
    want_s, want_i = jax_knn.knn_search(queries, jax_keys, k=6, keys_normalized=True,
                                        selector="approx")
    np.testing.assert_array_equal(ap_i, want_i)
    np.testing.assert_allclose(ap_s, want_s, rtol=0, atol=SCORE_ATOL)
    with pytest.raises(ValueError, match="selector"):
        port_knn.knn_search(queries, prepared, selector="fast")


def test_n_valid_keys_slices_padding_rows():
    """Rows past n_valid_keys never rank: a zero pad row would outrank a
    negative score."""
    rng = np.random.default_rng(13)
    keys = rng.standard_normal((10, 16)).astype(np.float32)
    keys[:, 0] = -8.0  # every real key scores below zero against e0
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    padded = np.concatenate([keys, np.zeros((6, 16), np.float32)])
    q = np.eye(3, 16, dtype=np.float32)
    for dtype in ("float32", "int8"):
        want_s, want_i = port_knn.knn_search(q, port_knn.prepare_keys(keys.copy(), "cpu", dtype),
                                             k=4, keys_normalized=True)
        got_s, got_i = port_knn.knn_search(q, port_knn.prepare_keys(padded.copy(), "cpu", dtype),
                                           k=4, keys_normalized=True, n_valid_keys=10)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)
        assert got_i.max() < 10


def test_rerank_candidates_bit_equal_to_jax():
    rng = np.random.default_rng(17)
    keys = rng.standard_normal((300, 48)).astype(np.float32) * 2
    queries = rng.standard_normal((7, 48)).astype(np.float32)
    cand = rng.integers(0, 300, (7, 24))
    for k in (1, 5, 24, 30):
        want = jax_knn.rerank_candidates(queries, cand, keys, k=k)
        got = port_knn.rerank_candidates(queries, cand, keys, k=k)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_int8_with_rerank_equals_exact_fp32_topk():
    """The int8 gallery searched at 4x oversample and re-ranked against the
    fp32 rows gives the exact fp32 top-k: the same indices, the scores to
    fp32 noise."""
    rng = np.random.default_rng(19)
    keys = _unit_rows(rng, 4000, 64)
    queries = keys[rng.integers(0, 4000, 12)] + 0.05 * rng.standard_normal((12, 64)).astype(
        np.float32)
    exact_s, exact_i = port_knn.knn_search(queries, keys, k=10, device="cpu")
    _, cand = port_knn.knn_search(queries, port_knn.prepare_keys(keys.copy(), "cpu", "int8"), k=40,
                                  selector="approx")
    got_s, got_i = port_knn.rerank_candidates(queries, cand, keys, k=10)
    np.testing.assert_array_equal(got_i, exact_i)
    np.testing.assert_allclose(got_s, exact_s, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("call", ["knn_search_mesh", "knn_search_shard_keys", "prepare_keys_mesh"])
def test_sharded_search_raises(call):
    """The sharded calls, once raising, are ported: over the CPU named
    twice each equals the unsharded search (tests/test_torch_sharded_knn.py
    holds them against the JAX package)."""
    rng = np.random.default_rng(23)
    keys, q = _unit_rows(rng, 7, 4), _unit_rows(rng, 3, 4)
    mesh = ["cpu", "cpu"]
    want = port_knn.knn_search(q, keys, k=3, device="cpu")
    got = {"knn_search_mesh": lambda: port_knn.knn_search(q, keys, k=3, mesh=mesh, device="cpu"),
           "knn_search_shard_keys": lambda: port_knn.knn_search(q, keys, k=3, mesh=mesh,
                                                                shard="keys", device="cpu"),
           "prepare_keys_mesh": lambda: port_knn.knn_search(
               q, port_knn.prepare_keys(keys, "cpu", mesh=mesh), k=3, keys_normalized=True,
               shard="keys")}[call]()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
