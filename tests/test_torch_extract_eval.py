"""The port's slice against clibd_tpu: extraction on the tiny HDF5 fixture,
the embedding cache, the kNN search and eval grid, the `eval` CLI end to
end, and a guard that the port imports no jax."""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import jax

from clibd_tpu.config.schema import BertConfig, ExperimentConfig, ViTConfig
from clibd_tpu.data.pipeline import BatchSpec, BioscanLoader
from clibd_tpu.engine import evaluate as jax_evaluate
from clibd_tpu.engine import extract as jax_extract
from clibd_tpu.models import init_clibd_params
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.ops import knn as jax_knn
from clibd_tpu.parallel.mesh import create_mesh
from clibd_tpu_torch.engine import evaluate as port_evaluate
from clibd_tpu_torch.engine import extract as port_extract
from clibd_tpu_torch.engine.extract import save_embedding_export
from clibd_tpu_torch.models.convert import model_from_jax
from clibd_tpu_torch.ops import knn as port_knn

REPO = Path(__file__).resolve().parents[1]
SPLITS = (("all_keys", True), ("test_seen", False), ("test_unseen", False))
MODALITIES = ("image", "dna", "language")
# unit-norm fp32 embeddings: both packages round attention probabilities to
# bf16 after fp32 maths, so they agree to float noise except where a
# probability rounds the other way in one package; through a 2-layer encoder
# such a flip moves an embedding by < 1e-3 (the model tests bound it by the
# reference's own bf16-rounding gap).
EMB_ATOL = 1e-3


def tiny_cfg():
    cfg = ExperimentConfig()
    cfg.amp = False
    cfg.image.vit = ViTConfig(image_size=32, patch_size=16, hidden_size=128, num_layers=2,
                              num_heads=2, mlp_dim=256)
    cfg.dna.max_bp = 80  # 1 + 80/5 = 17 tokens
    cfg.dna.bert = BertConfig(vocab_size=1027, hidden_size=128, num_layers=2, num_heads=2,
                              intermediate_size=256, max_position_embeddings=40,
                              with_mlm_head=True)
    cfg.language.bert = BertConfig(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
                                   intermediate_size=256, max_position_embeddings=24)
    cfg.output_dim = 64
    return cfg


@pytest.fixture(scope="module")
def extracted(tiny_hdf5):
    """Both packages extract the three splits from the same params (JAX with
    its Pallas kernel in interpret mode, the same attention numerics as the
    port) → {split: (jax_dict, port_dict)}."""
    cfg = tiny_cfg()
    tree = jax.tree.map(np.asarray, init_clibd_params(jax.random.PRNGKey(1), cfg))
    for enc in ("image_encoder", "dna_encoder", "language_encoder"):
        w = tree[enc]["blocks"]["qkv_w"]
        tree[enc]["blocks"]["qkv_w"] = (np.random.default_rng(2).standard_normal(w.shape)
                                        * 0.1).astype(np.float32)
    model = model_from_jax(tree, cfg, "cpu")
    spec = BatchSpec(batch_size=6, image_size=32, resize_to=36, dna_max_bp=80, train=False)
    mesh = create_mesh(jax.devices()[:1])
    out = {}
    saved = jax_layers.ATTENTION_IMPL
    jax_layers.ATTENTION_IMPL = "pallas"
    try:
        for split, for_key in SPLITS:
            loader = BioscanLoader(tiny_hdf5, split, spec, num_workers=0)
            try:
                j = jax_extract.extract_split(tree, cfg, loader, for_key_set=for_key, mesh=mesh)
                p = port_extract.extract_split(model, cfg, loader, for_key_set=for_key)
            finally:
                loader.close()
            out[split] = (j, p)
    finally:
        jax_layers.ATTENTION_IMPL = saved
    return out


@pytest.mark.parametrize("split", [s for s, _ in SPLITS])
def test_extract_split_matches_jax(extracted, split):
    j, p = extracted[split]
    assert set(j) == set(p)
    for key in jax_extract.ALL_TYPE_OF_FEATURES_OF_KEY:
        if j[key] is None:
            assert p[key] is None, key
            continue
        assert p[key].shape == j[key].shape and p[key].dtype == np.float32, key
        np.testing.assert_allclose(p[key], j[key], atol=EMB_ATOL, err_msg=key)
    for key in ("label_list", "file_name_list", "processed_id_list", "all_key_features_label"):
        assert p[key] == j[key], key
    for m in MODALITIES:
        np.testing.assert_allclose(np.linalg.norm(p[f"encoded_{m}_feature"], axis=1), 1,
                                   atol=1e-5)


def test_cache_files_match_jax_schema(extracted, tmp_path):
    """The port's writers produce the JAX writers' groups, datasets, shapes,
    dtypes and values, and byte-identical label / id JSONs; both loaders
    read the port's files back identically."""
    keys, seen, unseen = (extracted[s][1] for s, _ in SPLITS)
    paths = {}
    for name, mod in (("jax", jax_extract), ("port", port_extract)):
        d = tmp_path / name
        d.mkdir()
        paths[name] = (str(d / "feat.hdf5"), str(d / "labels.json"), str(d / "ids.json"))
        mod.save_extracted_features(paths[name][0], seen, unseen, keys)
        mod.save_labels_and_ids(paths[name][1], paths[name][2], seen, unseen, keys)
    with h5py.File(paths["jax"][0]) as fj, h5py.File(paths["port"][0]) as fp:
        assert set(fj) == set(fp) == {"seen", "unseen", "key"}
        for g in fj:
            assert set(fj[g]) == set(fp[g])
            for ds in fj[g]:
                assert fj[g][ds].shape == fp[g][ds].shape and fj[g][ds].dtype == fp[g][ds].dtype
                np.testing.assert_array_equal(fj[g][ds][:], fp[g][ds][:])
    for i in (1, 2):
        assert Path(paths["jax"][i]).read_bytes() == Path(paths["port"][i]).read_bytes()
    got = port_extract.load_extracted_features(*paths["port"])
    want = jax_extract.load_extracted_features(*paths["port"])
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k]


def test_inference_and_eval_matches_jax(extracted):
    """Fed the same embeddings (tie-free), both grids agree exactly."""
    keys, seen, unseen = (extracted[s][0] for s, _ in SPLITS)
    got = port_evaluate.inference_and_eval(keys, seen, unseen, k_list=(1, 3, 5), query_chunk=7,
                                           device="cpu")
    want = jax_evaluate.inference_and_eval(keys, seen, unseen, k_list=(1, 3, 5), query_chunk=7)
    assert got[0] == want[0]  # acc_dict
    assert got[1] == want[1]  # per_class_acc
    assert json.dumps(got[2], sort_keys=True, default=str) == \
        json.dumps(want[2], sort_keys=True, default=str)
    meta = {"learning_strategy": "FineTuning", "epochs": 3, "output_dim": 64}
    assert port_evaluate.format_results(got[0], (1, 3, 5), "I,D,T", meta) == \
        jax_evaluate.format_results(want[0], (1, 3, 5), "I,D,T", meta)
    assert port_evaluate.compute_overall_acc(got[0]) == jax_evaluate.compute_overall_acc(want[0])


def test_save_results_matches_jax(extracted, tmp_path):
    keys, seen, unseen = (extracted[s][0] for s, _ in SPLITS)
    acc = port_evaluate.inference_and_eval(keys, seen, unseen, with_preds=False, device="cpu")[0]
    _, csv_rows, raw_rows, _ = port_evaluate.format_results(acc)
    for name, mod in (("jax", jax_evaluate), ("port", port_evaluate)):
        mod.save_results(str(tmp_path / name), acc, csv_rows, raw_rows, config_snapshot={"a": 1})
    for f in ("accuracy.json", "results.csv", "raw.csv", "config.yaml"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()


def test_knn_search_matches_jax(rng):
    """Tie-free random data: same neighbours, same scores to fp32 noise;
    query chunks of every size give the same answer."""
    q = rng.standard_normal((37, 16)).astype(np.float32)
    k = rng.standard_normal((53, 16)).astype(np.float32)
    want_s, want_i = jax_knn.knn_search(q, k, k=5, query_chunk=8)
    for chunk in (1, 8, 4096):
        got_s, got_i = port_knn.knn_search(q, k, k=5, query_chunk=chunk, device="cpu")
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    names = [f"key_{i}" for i in range(53)]
    got_n, got_s = port_knn.find_k_closest_records(q, k, names, k=3, device="cpu")
    want_n, want_s = jax_knn.find_k_closest_records(q, k, names, k=3)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    labels = [{"order": f"o{i % 2}", "family": f"f{i % 3}", "genus": f"g{i % 5}",
               "species": f"s{i}"} for i in range(53)]
    assert port_knn.make_prediction(q, k, labels, max_k=3, device="cpu") == \
        jax_knn.make_prediction(q, k, labels, max_k=3)
    prepared = port_knn.prepare_keys(k, device="cpu")
    np.testing.assert_allclose(prepared.norm(dim=1).numpy(), 1, atol=1e-6)


@pytest.mark.parametrize("k", range(1, 9))
def test_knn_search_breaks_ties_as_jax(k):
    """Duplicated keys: 7 distinct rows, each three times (indices i, i + 7,
    i + 14), so every query meets exact ties, some straddling the k-th
    place.  jax.lax.top_k puts the lower index first among equal scores;
    the port must give the same indices in the same order, not just the
    same sets, with query chunks smaller than the query count."""
    rng = np.random.default_rng(40 + k)
    rows = rng.standard_normal((7, 16)).astype(np.float32)
    keys = np.concatenate([rows, rows, rows])
    queries = np.concatenate([rows[[0, 3, 6]], rng.standard_normal((4, 16)).astype(np.float32)])
    want_s, want_i = jax_knn.knn_search(queries, keys, k=k, query_chunk=3)
    got_s, got_i = port_knn.knn_search(queries, keys, k=k, query_chunk=3, device="cpu")
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    labels = [{"order": f"o{i % 2}", "family": f"f{i % 3}", "genus": f"g{i % 5}",
               "species": f"s{i}"} for i in range(21)]
    assert port_knn.make_prediction(queries, keys, labels, max_k=k, query_chunk=2,
                                    device="cpu") == \
        jax_knn.make_prediction(queries, keys, labels, max_k=k)


def test_top_k_lower_index_first_example():
    """The example that showed the fault: 18 keys (6 rows, each three
    times), query 0 equal to key 0, k=5 → [0 6 12 1 7] or its like: the
    three copies of the best row in index order, then the lowest-indexed
    copies of the next."""
    scores = torch.tensor([[3.0, 2.0, 1.0] * 6])
    vals, idx = port_knn.top_k_lower_index_first(scores, 5)
    assert idx.tolist() == [[0, 3, 6, 9, 12]]
    assert vals.tolist() == [[3.0] * 5]
    vals, idx = port_knn.top_k_lower_index_first(scores, 8)
    assert idx.tolist() == [[0, 3, 6, 9, 12, 15, 1, 4]]
    assert vals.tolist() == [[3.0] * 6 + [2.0] * 2]


TINY_EXP = """
model_output_name: tiny_torch
dataset: bioscan_1m
batch_size: 5
epochs: 1
output_dim: 32
disable_lora: false
load_ckpt: false
default_seed: 42
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 128, num_layers: 2, num_heads: 2,
        mlp_dim: 256}
dna:
  bert: {vocab_size: 1027, hidden_size: 128, num_layers: 2, num_heads: 2,
         intermediate_size: 256, max_position_embeddings: 140, with_mlm_head: true}
language:
  bert: {vocab_size: 1000, hidden_size: 128, num_layers: 2, num_heads: 2,
         intermediate_size: 256, max_position_embeddings: 24}
"""


def _run_cli(tmp_path, *extra):
    exp = tmp_path / "tiny.yaml"
    exp.write_text(TINY_EXP)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "clibd_tpu_torch.cli", "eval", "-e", str(exp), "--device", "cpu",
         *extra, "project_root_path=" + str(tmp_path), "pipeline.num_workers=0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_cli_eval_end_to_end(tiny_hdf5, tmp_path):
    """`python -m clibd_tpu_torch.cli eval` on the fixture: prints the table,
    writes the cache in the JAX package's schema and the reports, and a
    second run with load_inference reads the cache back."""
    proc = _run_cli(tmp_path, "--hdf5", tiny_hdf5)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Seen Order" in proc.stdout and "fresh init" in proc.stdout
    folder = tmp_path / "extracted_embedding" / "bioscan_1m" / "tiny_torch"
    for f in ("extracted_feature_from_test_split.hdf5", "labels_test.json",
              "processed_id_test.json", "acc_dict_test.json", "report.html"):
        assert (folder / f).exists(), f
    assert (tmp_path / "logs" / "results.csv").exists()
    with h5py.File(folder / "extracted_feature_from_test_split.hdf5") as f:
        assert set(f) == {"seen", "unseen", "key"}
        assert f["key"]["all_key_features"].shape == (36, 32)
        assert f["seen"]["encoded_image_feature"].shape == (12, 32)
    proc = _run_cli(tmp_path, "--hdf5", tiny_hdf5, "load_inference=true",
                    "inference_and_eval_setting.plot_embeddings=false")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Loading embeddings from file" in proc.stdout and "Seen Order" in proc.stdout


def test_options_not_ported_raise(tmp_path, tiny_hdf5):
    """Every option is ported now, and none raises.  The sharded gallery:
    prepare_keys(mesh=) and a sharded knn_search equal the unsharded search,
    and `serve --shard-keys --device cpu` answers a /search request.  The
    image retrieval grids and the similarity distributions: `eval` writes
    them (held against the JAX package in tests/test_torch_retrieval_grid.py)."""
    rng = np.random.default_rng(29)
    keys = rng.standard_normal((5, 4)).astype(np.float32)
    q = rng.standard_normal((3, 4)).astype(np.float32)
    want = port_knn.knn_search(q, keys, k=2, device="cpu")
    sharded = port_knn.prepare_keys(keys, device="cpu", mesh=["cpu", "cpu"])
    for got in (port_knn.knn_search(q, sharded, k=2, keys_normalized=True),
                port_knn.knn_search(q, keys, k=2, mesh=["cpu", "cpu"], device="cpu")):
        np.testing.assert_array_equal(got[1], want[1])
    exp = tmp_path / "tiny.yaml"
    exp.write_text(TINY_EXP)
    gallery = tmp_path / "gallery.hdf5"
    save_embedding_export(str(gallery), {
        "encoded_image_feature": rng.standard_normal((7, 32)).astype(np.float32),
        "encoded_dna_feature": rng.standard_normal((7, 32)).astype(np.float32),
        "encoded_language_feature": None, "file_name_list": [f"f{i}" for i in range(7)],
        "label_list": [{lv: f"{lv}{i}" for lv in ("order", "family", "genus", "species")}
                       for i in range(7)]})
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "clibd_tpu_torch.cli", "serve", "-e", str(exp),
                             "--device", "cpu", "--shard-keys", "--keys", str(gallery),
                             "--port", "0", "--no-warm"], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("serving on "):
                port = int(line.split(":")[2].split()[0])
                break
        assert port, "the server did not start"
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}/search", method="POST",
            data=json.dumps({"dna": "ACGTACGTAAACCCGGGTTTACGT", "k": 3}).encode())
        with urllib.request.urlopen(request, timeout=120) as resp:
            answer = json.loads(resp.read())
        assert len(answer["dna"]["predictions"]) == 3 and len(answer["dna"]["scores"]) == 3
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    proc = _run_cli(tmp_path, "--hdf5", tiny_hdf5,
                    "inference_and_eval_setting.retrieve_images=true",
                    "inference_and_eval_setting.similarity_distributions=true",
                    "inference_and_eval_setting.plot_embeddings=false")
    assert proc.returncode == 0 and "NotImplementedError" not in proc.stderr, proc.stderr[-3000:]
    folder = tmp_path / "extracted_embedding" / "bioscan_1m" / "tiny_torch"
    for name in ("retrieval/retrieved_images.json", "similarity_distances.csv",
                 "similarity_distributions.png"):
        assert (folder / name).stat().st_size > 0, name


def test_port_imports_no_jax():
    """Every module of clibd_tpu_torch imports with jax and the JAX package
    made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['clibd_tpu'] = None\n"
        "import clibd_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(clibd_tpu_torch.__path__, "
        "'clibd_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "print('imported', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


@pytest.mark.parametrize("script", ["chip_smoke.py", "clibd_tpu_torch/tools/profile_extract.py",
                                    "clibd_tpu_torch/tools/exp_attn.py",
                                    "clibd_tpu_torch/tools/exp_mxu.py",
                                    "clibd_tpu_torch/tools/exp_mxu2.py"])
def test_card_scripts_name_only_the_port(script):
    """The scripts that drive the port on the card import neither jax nor a
    `clibd_tpu` module; what they reuse of it they reach through the port."""
    import ast

    tree = ast.parse((REPO / script).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "clibd_tpu"}, sorted(tops)


def test_synthetic_split_matches_jax_extraction():
    """`SyntheticSplit` (ragged last batch) feeds both packages' extract_split
    through the loader interface; the features agree as on the fixture."""
    from clibd_tpu_torch.data import SyntheticSplit

    cfg = tiny_cfg()
    cfg.batch_size = 3
    tree = jax.tree.map(np.asarray, init_clibd_params(jax.random.PRNGKey(3), cfg))
    model = model_from_jax(tree, cfg, "cpu")
    split = SyntheticSplit("keys", 7, cfg, seed=4)
    assert len(split) == 3 and split.spec.batch_size == 3
    saved = jax_layers.ATTENTION_IMPL
    jax_layers.ATTENTION_IMPL = "pallas"
    try:
        j = jax_extract.extract_split(tree, cfg, split, for_key_set=True,
                                      mesh=create_mesh(jax.devices()[:1]))
    finally:
        jax_layers.ATTENTION_IMPL = saved
    p = port_extract.extract_split(model, cfg, split, for_key_set=True)
    for m in MODALITIES:
        emb = p[f"encoded_{m}_feature"]
        assert emb.shape == (7, cfg.output_dim)
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
        np.testing.assert_allclose(emb, j[f"encoded_{m}_feature"], atol=EMB_ATOL)
    assert p["all_key_features"].shape == (21, cfg.output_dim)
    assert p["file_name_list"] == [f"keys_{i}" for i in range(7)]


def test_device_idle_share_reads_the_trace():
    """Idle share = the traced span minus the union of device intervals
    (overlaps counted once, CPU ops ignored, clipped to the span)."""
    from clibd_tpu_torch.tools.profile_extract import (device_idle_share, device_ms_by_group,
                                                       trace_window)

    events = [
        {"cat": "user_annotation", "name": "extract_split", "ts": 100.0, "dur": 100.0},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 100.0, "dur": 100.0},
        {"cat": "kernel", "name": "nvjet_hsh_256x128", "ts": 110.0, "dur": 20.0},
        {"cat": "kernel", "name": "flash_fwd_bf16_kernel<13>", "ts": 120.0, "dur": 20.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150.0, "dur": 10.0},
        {"cat": "kernel", "name": "vectorized_elementwise_kernel", "ts": 190.0, "dur": 30.0},
    ]
    window = trace_window(events, "extract_split")
    assert window == (100.0, 200.0)
    # busy: [110, 140) + [150, 160) + [190, 200) = 50 of 100 us
    assert device_idle_share(events, window) == pytest.approx(0.5)
    # no span launched the attention kernel: it is grouped by its name, and
    # no name fragment makes an attention group
    groups = device_ms_by_group(events, window)
    assert groups == pytest.approx({"elementwise and reductions": 0.05, "gemm": 0.02,
                                    "host<->device copies": 0.01})
    with pytest.raises(RuntimeError, match="no 'other' span"):
        trace_window(events, "other")


def test_attention_groups_read_the_spans():
    """The attention groups are the device time that the `attn.*` spans
    launched, whatever the kernels are named.  An operation belongs to the
    innermost span open on its launching thread (the runtime call with its
    correlation); autograd's thread, with no span open, launches for the
    span the loop's thread is in.  A trace of CUDA activity alone names a
    thread by its pthread id's low 32 bits as a signed int32 made positive
    (0x7f26a0bff6c0 is 0x5f400940); with host activity, by its native id."""
    from benchmark.core.spans import Spans
    from clibd_tpu_torch.tools.profile_extract import device_ms_by_group

    def span(name, ts, dur, sid, parent=None, tid=5, ident=0x7FBF00F7B300):
        return {"ph": "X", "cat": "span", "name": name, "pid": 1, "tid": tid, "ts": ts,
                "dur": dur, "args": {"id": sid, "parent": parent, "unit": 0, "ident": ident}}

    def op(name, ts, dur, corr, launch_ts, tid=5, cat="kernel"):
        return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": launch_ts,
                 "dur": 1.0, "args": {"correlation": corr}},
                {"cat": cat, "name": name, "tid": 7, "ts": ts, "dur": dur,
                 "args": {"correlation": corr}}]

    spans = [span("train.step", 0.0, 500.0, 1), span("attn.fwd", 10.0, 20.0, 2, 1),
             span("step.backward", 90.0, 100.0, 3, 1),
             span("attn.bwd", 100.0, 20.0, 4, 3, tid=6, ident=0x7F26A0BFF6C0),
             span("attn.outproj", 200.0, 10.0, 5, 1)]
    events = (op("any_renamed_kernel", 40.0, 30.0, 1, 12.0)
              + op("flash_fwd_bf16_kernel", 80.0, 10.0, 2, 40.0)       # launched outside
              + op("fused_bwd", 130.0, 50.0, 3, 105.0, tid=0x5F400940)
              + op("elementwise_bwd", 185.0, 5.0, 7, 125.0, tid=0x5F400940)
              + op("outproj_wgmma", 210.0, 40.0, 4, 201.0)
              + op("nvjet_hsh_256x128", 300.0, 20.0, 5, 250.0)
              + op("Memcpy HtoD", 330.0, 10.0, 6, 260.0, cat="gpu_memcpy"))
    owners = Spans(events, spans).owner
    assert {events[i]["name"]: o["name"] for i, o in owners.items()} == {
        "any_renamed_kernel": "attn.fwd", "flash_fwd_bf16_kernel": "train.step",
        "fused_bwd": "attn.bwd", "elementwise_bwd": "step.backward",
        "outproj_wgmma": "attn.outproj", "nvjet_hsh_256x128": "train.step",
        "Memcpy HtoD": "train.step"}
    groups = device_ms_by_group(events, (0.0, 500.0), owners)
    assert groups == pytest.approx({"attention forward": 0.03, "attention backward": 0.05,
                                    "attention + out-projection": 0.04, "gemm": 0.02,
                                    "elementwise and reductions": 0.015,
                                    "host<->device copies": 0.01})


def test_wrapper_on_cpu_needs_no_cuda():
    """A CPU tensor never touches the CUDA build: the plain versions run."""
    from clibd_tpu_torch.ops import attention, cuda_build, mlp

    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 5, 3 * 128, generator=g)
    out = attention.flash_attention_qkv(qkv, 2)
    w, b = torch.randn(128, 128, generator=g), torch.randn(128, generator=g)
    proj = attention.flash_attention_qkv_outproj(qkv, w, b, 2)
    h = mlp.fused_mlp(out, torch.randn(128, 64, generator=g), torch.zeros(64),
                      torch.randn(64, 128, generator=g), torch.zeros(128))
    assert out.shape == proj.shape == h.shape == (2, 5, 128)
    assert cuda_build._LOADED == {} and cuda_build._FUNCTIONS == {}
