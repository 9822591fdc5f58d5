"""The port's seen/unseen fusion (`clibd_tpu_torch/engine/fusion.py`) against
clibd_tpu's on the CPU: every numpy function on seeded [N, k] inputs, the
method_nn and method_linear pipelines on seeded unit features, and the
linear probe's AdamW fit from the JAX package's own initial weights.  Every
input comes from a generator seeded here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.engine import fusion as jax_fusion
from clibd_tpu_torch.engine import fusion as port_fusion

LEVELS = ("order", "family", "genus", "species")
PROBE_REL_TOL = 1e-5   # 50 probe steps: |w_port - w_jax| <= 1e-5 * max |w_jax|, the same for b
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the suite's workers would
    oversubscribe the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(rng, n, species):
    s = rng.integers(0, len(species), n)
    return {lv: np.asarray([f"{lv}_{species[i] % m}" for i in s], dtype=object)
            for lv, m in zip(LEVELS, (3, 5, 7, 10 ** 6))}


def _split(seed, n=40, k=5):
    rng = np.random.default_rng(seed)
    seen, unseen = list(range(6)), list(range(6, 12))
    return {"preds_seen": {lv: v.reshape(n, k) for lv, v in _labels(rng, n * k, seen).items()},
            "scores_seen": np.sort(rng.random((n, k)), axis=1)[:, ::-1].astype(np.float32),
            "preds_unseen": {lv: v.reshape(n, k)
                             for lv, v in _labels(rng, n * k, unseen).items()},
            "gt": _labels(rng, n, seen if seed % 2 else unseen),
            "side_species": {f"species_{s}" for s in (seen if seed % 2 else unseen)}}


def _same(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for key in a:
            _same(a[key], b[key], f"{what}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("threshold", [0.0, 0.35, 0.8])
def test_fuse_and_routing_equal_jax(threshold):
    split = _split(1)
    args = (split["preds_seen"], split["scores_seen"], split["preds_unseen"], threshold)
    fused = port_fusion.fuse_predictions(*args)
    _same(fused, jax_fusion.fuse_predictions(*args))
    _same(port_fusion.routing_accuracy(fused["species"], split["side_species"]),
          jax_fusion.routing_accuracy(fused["species"], split["side_species"]))
    assert port_fusion.harmonic_mean_list([0.5, 0.25]) == jax_fusion.harmonic_mean_list(
        [0.5, 0.25])


@pytest.mark.parametrize("k_list", [(1, 3, 5), (3, 5)])
def test_threshold_search_and_evaluation_equal_jax(k_list):
    data = [_split(1), _split(2)]
    t = port_fusion.search_threshold(data, k_list=k_list, num_intervals=200)
    assert t == jax_fusion.search_threshold(data, k_list=k_list, num_intervals=200)
    _same(port_fusion.evaluate_with_threshold(data, t, k_list=k_list),
          jax_fusion.evaluate_with_threshold(data, t, k_list=k_list))


def test_classifier_predictions_and_fusion_equal_jax():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((30, 16)).astype(np.float32)
    w = rng.standard_normal((16, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    classes = [f"species_{i}" for i in range(6)]
    s2l = {c: {"order": f"o{i % 2}", "family": f"f{i % 3}", "genus": f"g{i}", "species": c}
           for i, c in enumerate(classes)}
    class_labels = port_fusion.class_labels_by_level_from_map(classes, s2l)
    _same(class_labels, jax_fusion.class_labels_by_level_from_map(classes, s2l))
    logits = feats @ w + b
    _same(port_fusion.predictions_from_logits(logits, class_labels),
          jax_fusion.predictions_from_logits(logits, class_labels))
    _same(port_fusion.classifier_predictions(feats, w, b, class_labels),
          jax_fusion.classifier_predictions(feats, w, b, class_labels))

    side_a = [port_fusion.classifier_predictions(feats[i::2], w, b, class_labels)
              for i in range(2)]
    q = [{"image": feats[i::2], "dna": feats[i::2][::-1].copy()} for i in range(2)]
    keys = rng.standard_normal((20, 16)).astype(np.float32)
    key_labels = _labels(rng, 20, list(range(6, 12)))
    gts = [_labels(rng, 15, list(range(6))), _labels(rng, 15, list(range(6, 12)))]
    for side_b in ("image", "dna"):
        got = port_fusion.method_from_classifier(side_a, *q, keys, key_labels, *gts, classes,
                                                 side_b_query=side_b, device=CPU)
        want = jax_fusion.method_from_classifier(side_a, *q, keys, key_labels, *gts, classes,
                                                 side_b_query=side_b)
        _same(got, want, side_b)


def _unit(rng, n, d=32):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pipeline_inputs(seed):
    """Seen and unseen queries near their species' prototypes (so the
    threshold matters), seen image keys and unseen DNA keys."""
    rng = np.random.default_rng(seed)
    protos = _unit(rng, 12)

    def specimens(species, n):
        s = rng.choice(species, n)
        x = protos[s] + 0.6 * _unit(rng, n)
        labels = {lv: np.asarray([f"{lv}_{i % m}" for i in s], dtype=object)
                  for lv, m in zip(LEVELS, (3, 5, 7, 100))}
        return x / np.linalg.norm(x, axis=1, keepdims=True), labels

    seen, unseen = np.arange(6), np.arange(6, 12)
    (qs_i, gt_s), (qu_i, gt_u) = specimens(seen, 30), specimens(unseen, 30)
    (sk, sk_l), (uk, uk_l) = specimens(seen, 40), specimens(unseen, 40)
    queries = ({"image": qs_i, "dna": _unit(rng, 30)}, {"image": qu_i, "dna": _unit(rng, 30)})
    return queries, (sk, sk_l), (uk, uk_l), (gt_s, gt_u)


@pytest.mark.parametrize("side_b", ["image", "dna"])
def test_method_nn_equals_jax(side_b):
    queries, (sk, sk_l), (uk, uk_l), gts = _pipeline_inputs(4)
    got = port_fusion.method_nn(*queries, sk, sk_l, uk, uk_l, *gts, side_b_query=side_b,
                                device=CPU)
    want = jax_fusion.method_nn(*queries, sk, sk_l, uk, uk_l, *gts, side_b_query=side_b)
    assert got["best_threshold"] == want["best_threshold"]
    _same(got, want)


def test_method_linear_with_a_given_probe_equals_jax():
    queries, (sk, sk_l), (uk, uk_l), gts = _pipeline_inputs(5)
    rng = np.random.default_rng(6)
    classes = sorted(set(sk_l["species"]))
    probe = (rng.standard_normal((32, len(classes))).astype(np.float32),
             rng.standard_normal(len(classes)).astype(np.float32), classes)
    s2l = {s: {lv: sk_l[lv][list(sk_l["species"]).index(s)] for lv in LEVELS} for s in classes}
    got = port_fusion.method_linear(None, None, *queries, uk, uk_l, *gts, s2l,
                                    trained_probe=probe, device=CPU)
    want = jax_fusion.method_linear(None, None, *queries, uk, uk_l, *gts, s2l,
                                    trained_probe=probe)
    assert got["best_threshold"] == want["best_threshold"]
    _same(got, want)


def test_linear_probe_fit_matches_jax():
    """From the JAX package's own initial w (0.01 * jax.random.normal with
    the seed's key): after 50 AdamW steps w and b agree within 1e-5 of
    max |w|; after 500, the fitted probes give every training row the same
    class."""
    rng = np.random.default_rng(7)
    n, d, c = 96, 24, 7
    y = rng.integers(0, c, n)
    x = (rng.standard_normal((c, d))[y] + 0.8 * rng.standard_normal((n, d))).astype(np.float32)
    w0 = np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(0), (d, c), jnp.float32))
    b0 = np.zeros(c, np.float32)
    for steps in (50, 500):
        jw, jb = jax_fusion.train_linear_probe(x, y, c, steps=steps, seed=0)
        pw, pb = port_fusion.fit_linear_probe(x, y, w0, b0, steps=steps, device=CPU)
        if steps == 50:
            tol = PROBE_REL_TOL * np.abs(jw).max()
            np.testing.assert_allclose(pw, jw, rtol=0, atol=tol)
            np.testing.assert_allclose(pb, jb, rtol=0, atol=tol)
        else:
            assert np.array_equal((x @ pw + pb).argmax(1), (x @ jw + jb).argmax(1))
    # the port's own init: 0.01 * N(0, 1) from its generator, b zero
    w, b = port_fusion.init_linear_probe(d, c, seed=0)
    assert w.shape == (d, c) and 0.005 < float(w.std()) < 0.015 and not b.any()
    fw, fb = port_fusion.train_linear_probe(x, y, c, steps=5, device=CPU)
    assert fw.shape == (d, c) and fb.shape == (c,) and np.isfinite(fw).all()
