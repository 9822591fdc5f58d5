"""The port's sharded kNN over a list of devices (the CPU named 2 and 4
times) against `clibd_tpu/ops/knn.py` on 2- and 4-device CPU meshes: query
sharding against `_knn_sharded`, key sharding against `knn_search(mesh=,
shard="keys")` over `prepare_keys(mesh=)`'s padded gallery, with exact ties
(repeated keys), a row count the shards do not divide (pad rows present)
and a shard smaller than k; the int8 gallery with the host re-rank; and
`KeySet(mesh=)` and an `InferenceService(keys_mesh=)` answering a request
over HTTP.  Every input is drawn here from a seeded generator.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax

from clibd_tpu.ops import knn as jax_knn
from clibd_tpu.parallel.mesh import create_mesh as jax_create_mesh
from clibd_tpu_torch.config import LEVELS
from clibd_tpu_torch.engine import serve as port_serve
from clibd_tpu_torch.ops import knn as port_knn

SCORE_ATOL = 1e-6   # fp32 scores of the same products
RERANK_ATOL = 1e-5  # tests/test_torch_knn.py's, int8 + re-rank against exact fp32
DEVICES = [2, 4]


def _gallery(seed, n, d, repeats=True):
    """Unit rows, some of them repeated (exact ties), and queries near rows."""
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((n, d)).astype(np.float32)
    if repeats:
        keys[n // 2::7] = keys[1]  # ties across shards
    queries = keys[rng.integers(0, n, 9)] + 0.05 * rng.standard_normal((9, d)).astype(np.float32)
    queries[0] = keys[1]
    return keys, queries


@pytest.mark.parametrize("n_dev", DEVICES)
@pytest.mark.parametrize("n,k,chunk", [(61, 5, 4096), (200, 8, 4)])
def test_query_sharded_matches_jax(n_dev, n, k, chunk):
    keys, queries = _gallery(n + n_dev, n, 16)
    mesh = jax_create_mesh(jax.devices()[:n_dev])
    want_s, want_i = jax_knn._knn_sharded(queries, keys, k, chunk, True, False, mesh)
    got_s, got_i = port_knn.knn_search(queries, keys, k=k, query_chunk=chunk,
                                       mesh=["cpu"] * n_dev, shard="queries", device="cpu")
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("n_dev", DEVICES)
@pytest.mark.parametrize("n,k,chunk", [(61, 5, 4096), (203, 16, 3), (6, 5, 4096)])
def test_key_sharded_matches_jax(n_dev, n, k, chunk):
    """Pad rows present (61 and 203 rows do not divide over 2 or 4); 6 rows
    over 4 devices leave shards of 2 < k rows, searched whole."""
    keys, queries = _gallery(3 * n + n_dev, n, 16)
    mesh = jax_create_mesh(jax.devices()[:n_dev])
    jkeys = jax_knn.prepare_keys(keys.copy(), mesh=mesh)
    want_s, want_i = jax_knn.knn_search(queries, jkeys, k=k, query_chunk=chunk,
                                        keys_normalized=True, mesh=mesh, shard="keys",
                                        n_valid_keys=n)
    pkeys = port_knn.prepare_keys(keys.copy(), mesh=["cpu"] * n_dev)
    assert isinstance(pkeys, port_knn.ShardedKeys) and pkeys.n_valid == n
    assert len(pkeys.shards) == n_dev and sum(s.shape[0] for s in pkeys.shards) % n_dev == 0
    got_s, got_i = port_knn.knn_search(queries, pkeys, k=k, query_chunk=chunk,
                                       keys_normalized=True, shard="keys", n_valid_keys=n)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=0, atol=SCORE_ATOL)
    assert (got_i < n).all()
    # ties: query 0 is row 1, whose copies come first, lower index first
    tied = [i for i in range(n) if np.array_equal(keys[i], keys[1])][:k]
    assert len(tied) > 1 and list(got_i[0, :len(tied)]) == tied
    # a plain matrix is split on the fly, and equals the unsharded search
    plain_s, plain_i = port_knn.knn_search(queries, keys, k=k, query_chunk=chunk, device="cpu")
    mesh_s, mesh_i = port_knn.knn_search(queries, keys, k=k, query_chunk=chunk,
                                         mesh=["cpu"] * n_dev, shard="keys", device="cpu")
    np.testing.assert_array_equal(mesh_i, plain_i)
    np.testing.assert_array_equal(got_i, plain_i)
    np.testing.assert_allclose(mesh_s, plain_s, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("n_dev", DEVICES)
def test_int8_key_sharded_with_rerank(n_dev):
    """The int8 gallery sharded as the fp32 one: the same rows and scales a
    shard, pad rows never ranked, and searched at 4x oversample and
    re-ranked, the exact fp32 top k (scores within 1e-5); the candidates
    equal the unsharded int8 search's, and JAX's where its scores are
    separated."""
    keys, queries = _gallery(77 + n_dev, 403, 32, repeats=False)
    k = 10
    exact_s, exact_i = port_knn.knn_search(queries, keys, k=k, device="cpu")
    sharded = port_knn.prepare_keys(keys.copy(), dtype="int8", mesh=["cpu"] * n_dev)
    q, scale = port_knn.quantize_keys(keys.copy())
    got_q = np.concatenate([s.q.numpy() for s in sharded.shards])
    got_scale = np.concatenate([s.scale.numpy() for s in sharded.shards])
    np.testing.assert_array_equal(got_q[:403], q)
    np.testing.assert_array_equal(got_scale[:403], scale)
    assert not got_q[403:].any() and sharded.n_valid == 403
    _, cand = port_knn.knn_search(queries, sharded, k=4 * k, shard="keys")
    whole = port_knn.prepare_keys(keys.copy(), device="cpu", dtype="int8")
    _, cand_whole = port_knn.knn_search(queries, whole, k=4 * k)
    np.testing.assert_array_equal(cand, cand_whole)
    got_s, got_i = port_knn.rerank_candidates(queries, cand, keys, k=k)
    np.testing.assert_array_equal(got_i, exact_i)
    np.testing.assert_allclose(got_s, exact_s, rtol=0, atol=RERANK_ATOL)
    mesh = jax_create_mesh(jax.devices()[:n_dev])
    jkeys = jax_knn.prepare_keys(keys.copy(), mesh=mesh, dtype="int8")
    js, ji = jax_knn.knn_search(queries, jkeys, k=4 * k, mesh=mesh, shard="keys")
    got_cs, _ = port_knn.knn_search(queries, sharded, k=4 * k, shard="keys")
    np.testing.assert_allclose(got_cs, np.asarray(js), rtol=0, atol=RERANK_ATOL)
    top = (-np.diff(np.asarray(js), axis=1)[:, :k] > RERANK_ATOL).all(axis=1)
    np.testing.assert_array_equal(cand[top, :k], np.asarray(ji)[top, :k])


def _labels(n):
    return {lv: [f"{lv}{i}" for i in range(n)] for lv in LEVELS}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_keyset_mesh_equals_the_unsharded_keyset(dtype):
    rng = np.random.default_rng(91)
    feats = {"encoded_image_feature": rng.standard_normal((45, 16)).astype(np.float32),
             "encoded_dna_feature": rng.standard_normal((45, 16)).astype(np.float32)}
    whole = port_serve.KeySet.from_arrays(feats, _labels(45), dtype=dtype, device="cpu")
    sharded = port_serve.KeySet.from_arrays(feats, _labels(45), dtype=dtype,
                                            mesh=["cpu"] * 4, device="cpu")
    assert all(isinstance(f, port_knn.ShardedKeys) for f in sharded.features.values())
    sharded.warm()
    q = rng.standard_normal((6, 16)).astype(np.float32)
    for key_type in feats:
        got_s, got_i = sharded.search(q, key_type, k=7)
        want_s, want_i = whole.search(q, key_type, k=7)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=SCORE_ATOL)


def test_service_with_sharded_keys_answers_over_http():
    """`InferenceService(keys_mesh=...)` behind `make_server`, as `serve
    --shard-keys` builds it: a barcode's /search answers with the planted
    row first."""
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.tools import bench_serve
    import torch

    mc = bench_serve.tiny_config()
    model = init_clibd_model(mc, torch.Generator().manual_seed(0), "cpu")
    svc = port_serve.InferenceService(model, mc, keys_mesh=["cpu", "cpu"], device="cpu",
                                      window_ms=1.0, buckets=(1,),
                                      image_size=mc.image.vit.image_size,
                                      resize_to=mc.image.vit.image_size)
    barcode = "ACGTACGTAAACCCGGGTTTACGT"
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((9, mc.output_dim)).astype(np.float32)
    feats[4] = svc.embed(dna=barcode)["dna"]
    svc.keys = port_serve.KeySet.from_arrays({"encoded_dna_feature": feats}, _labels(9),
                                             mesh=["cpu", "cpu"], device="cpu")
    server = port_serve.make_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        request = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/search", method="POST",
            data=json.dumps({"dna": barcode, "k": 3}).encode())
        with urllib.request.urlopen(request, timeout=60) as resp:
            answer = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    assert answer["dna"]["predictions"][0]["species"] == "species4"
    assert abs(answer["dna"]["scores"][0] - 1.0) < 1e-5
