"""The kNN, eval and input benches of `clibd_tpu_torch/tools/` on the CPU,
against the JAX package's scripts in `tools/` (imported by path, run at a
small size with their own argument parsing):

- `bench_knn`: the grid's data are the JAX script's, its 42 searches give
  the JAX script's top-5 indices, the first rows' CPU searches agree with
  the whole grid's, and `inference_and_eval` gives the JAX acc_dict; the
  int8 leg's recall rows at a small shape;
- `bench_eval`: the port's `eval` over the synthetic cache gives the JAX
  script's acc_dict;
- `bench_extract`: its extracted embeddings equal the JAX script's on the
  same weights and fixture at a tiny width;
- `bench_pipeline`, `bench_decode`: each runs at a small size and reports
  its rows (timing only: ROADMAP.md Queue 1 says why no JAX comparison).

The synthetic features are Gaussian, so no two scores tie closer than
float noise and the packages' fp32 searches select the same keys.
"""

import copy
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from clibd_tpu_torch.config import schema as port_schema
from clibd_tpu_torch.tools import (bench_decode, bench_eval, bench_extract, bench_knn,
                                   bench_pipeline)

REPO = Path(__file__).resolve().parents[1]
KNN = {"seen": 64, "unseen": 32, "keys": 100, "dim": 16}


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_knn():
    """The JAX script's main at a small size, its searches and its
    inference_and_eval recorded."""
    import clibd_tpu.engine.evaluate as jax_evaluate
    import clibd_tpu.ops.knn as jax_knn_mod

    jbk = _script("bench_knn")
    seen = {"searches": [], "grid": None}
    real_search, real_eval = jax_knn_mod.knn_search, jax_evaluate.inference_and_eval

    def search(queries, keys, *a, **k):
        s, i = real_search(queries, keys, *a, **k)
        seen["searches"].append(np.asarray(i))
        return s, i

    def evaluate(keys, s, u, *a, **k):
        out = real_eval(keys, s, u, *a, **k)
        seen["grid"] = (keys, s, u, out[0])
        return out

    argv = sys.argv
    jax_knn_mod.knn_search, jax_evaluate.inference_and_eval = search, evaluate
    try:
        sys.argv = ["bench_knn"] + [f"--{k}={v}" for k, v in KNN.items()]
        jbk.main()
    finally:
        jax_knn_mod.knn_search, jax_evaluate.inference_and_eval = real_search, real_eval
        sys.argv = argv
    return seen


def test_bench_knn_grid_is_the_jax_scripts(jax_knn):
    keys, seen, unseen = bench_knn.synth_grid(KNN["seen"], KNN["unseen"], KNN["keys"], KNN["dim"])
    jkeys, jseen, junseen, _ = jax_knn["grid"]
    for mine, theirs in ((keys, jkeys), (seen, jseen), (unseen, junseen)):
        assert set(mine) == set(theirs)
        for k, v in mine.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, theirs[k], err_msg=k)
            else:
                assert v == theirs[k], k
    dev = bench_knn.device_leg(keys, seen, unseen, "cpu")
    assert dev["searches"] == 42
    # the JAX script's searches: one warm-up, then the grid in its order
    jsearches = jax_knn["searches"][1:43]
    order = [(name, qt, kt) for qt, kt in bench_knn.grid_cells(keys, seen)
             for name in ("seen", "unseen")]
    assert list(dev["indices"]) == order
    for cell, want in zip(order, jsearches):
        np.testing.assert_array_equal(dev["indices"][cell], want, err_msg=str(cell))
    head, _ = bench_knn.subset_on_cpu(keys, seen, unseen, rows=8)
    for cell, idx in head["indices"].items():
        np.testing.assert_array_equal(idx, dev["indices"][cell][:8], err_msg=str(cell))
    check = bench_knn.near_tie_check(keys, seen, unseen, dev, head, rows=8)
    assert check == {"rows_differing": 0, "max_score_diff": 0.0, "ok": True}


def test_bench_knn_near_tie_check_tells_a_near_tie_from_a_wrong_key():
    keys, seen, unseen = bench_knn.synth_grid(6, 4, 50, 8)
    want = bench_knn.device_leg(keys, seen, unseen, "cpu")
    cell = ("seen", "encoded_image_feature", "encoded_image_feature")
    swapped = {"indices": dict(want["indices"]), "sims": dict(want["sims"])}
    idx = want["indices"][cell].copy()
    idx[0, [3, 4]] = idx[0, [4, 3]]  # ranks 4 and 5 swapped
    swapped["indices"][cell] = idx
    gap = float(want["sims"][cell][0, 3] - want["sims"][cell][0, 4])
    got = bench_knn.near_tie_check(keys, seen, unseen, swapped, want, rows=6, tol=2 * gap)
    assert got["rows_differing"] == 1 and got["ok"]
    assert not bench_knn.near_tie_check(keys, seen, unseen, swapped, want, rows=6,
                                        tol=gap / 2)["ok"]


def test_bench_knn_acc_dict_is_the_jax_scripts(jax_knn):
    keys, seen, unseen = bench_knn.synth_grid(KNN["seen"], KNN["unseen"], KNN["keys"], KNN["dim"])
    acc_dict, seconds = bench_knn.full_leg(keys, seen, unseen, "cpu")
    assert seconds > 0
    assert json.loads(json.dumps(acc_dict)) == json.loads(json.dumps(jax_knn["grid"][3]))


def test_bench_knn_int8_rows():
    rows = bench_knn.bench_int8(16, "cpu", shapes=((64, 500, "small"),))
    (r,) = rows
    assert r["label"] == "small" and 0.0 <= r["recall1_raw"] <= 1.0
    assert r["recall1_reranked"] >= r["recall1_raw"] and r["recall1_reranked"] > 0.9
    assert r["gallery_gb"] == (500 * 16 * 4 / 1e9, 500 * 20 / 1e9)


def test_bench_eval_acc_dict_is_the_jax_scripts(tmp_path, monkeypatch):
    import tempfile

    sizes = ["--seen", "40", "--unseen", "40", "--keys", "60", "--dim", "16", "--species", "12"]
    monkeypatch.chdir(tmp_path)  # `eval` writes logs/ where it runs
    jbe = _script("bench_eval")
    jroot = tmp_path / "jax"
    jroot.mkdir()
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(jroot))
    monkeypatch.setattr(sys, "argv", ["bench_eval"] + sizes)
    monkeypatch.delenv("CLIBD_EVAL_TIMING", raising=False)
    jbe.main()
    (jfile,) = jroot.rglob("acc_dict_test.json")
    with open(jfile) as f:
        want = json.load(f)
    monkeypatch.delenv("CLIBD_EVAL_TIMING", raising=False)
    proot = tmp_path / "port"
    proot.mkdir()
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(proot))
    out = bench_eval.main(sizes + ["--device", "cpu"])
    assert not proot.exists()  # the port's run removes its cache
    assert out["rc"] == 0 and out["wall_s"] > 0
    assert out["acc_dict"] == want


def _tiny_bench_cfg(schema):
    """The bench model's tiny stand-in in `schema`'s classes: one layer a
    tower, 32 wide, at the bench's 224 x 224 images and 133 DNA tokens."""
    cfg = schema.ExperimentConfig()
    cfg.image.vit = schema.ViTConfig(image_size=224, patch_size=32, hidden_size=32,
                                     num_layers=1, num_heads=2, mlp_dim=64)
    cfg.dna.bert = schema.BertConfig(vocab_size=1027, hidden_size=32, num_layers=1,
                                     num_heads=2, intermediate_size=64,
                                     max_position_embeddings=140, with_mlm_head=True)
    return cfg


def _tiny_port_bench_cfg():
    cfg = _tiny_bench_cfg(port_schema)
    cfg.language.enable = False
    cfg.disable_lora = True
    return cfg


def test_bench_extract_runs_at_a_tiny_width(monkeypatch, capsys):
    monkeypatch.setattr(bench_extract, "flagship_config", _tiny_port_bench_cfg)
    from clibd_tpu_torch.tools import bench as bench_mod

    monkeypatch.setattr(bench_mod, "ITERS", 1)
    monkeypatch.setattr(bench_mod, "PASSES", 1)
    monkeypatch.setattr(bench_mod, "WARMUP", 1)
    out = bench_extract.run(n_records=12, batch=8, workers=0, device="cpu")
    for key in ("host_only_samples_per_s", "device_only_samples_per_s",
                "end_to_end_samples_per_s"):
        assert out[key] > 0, key
    assert out["records"] == 12 and out["device"] == "cpu" and out["card"] is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_bench_extract_embeddings_equal_the_jax_scripts(monkeypatch, capsys):
    """The JAX script's main and the port's `run` at a tiny width on the same
    weights (the config and init patched in both), each over its own copy of
    the fixture file: the extracted test_seen split's labels and names are
    equal and its embeddings agree within bf16 rounding (2e-2 of the
    largest), and both report the same rows."""
    import clibd_tpu.config.schema as jax_schema
    import clibd_tpu.engine.extract as jax_extract
    import clibd_tpu.models as jax_models
    from clibd_tpu_torch.engine import extract as port_extract
    from clibd_tpu_torch.models import clibd as port_clibd
    from clibd_tpu_torch.models.convert import model_from_jax
    from clibd_tpu_torch.tools import bench as bench_mod
    from tests.torch_tiny import numpy_params

    trees, jax_out, port_out = [], [], []
    real_jax_extract, real_port_extract = jax_extract.extract_split, port_extract.extract_split
    real_init = jax_models.init_clibd_params

    def init(key, cfg):
        trees.append(numpy_params(lambda k: real_init(k, cfg), 4))
        return trees[-1]

    jcfg = _tiny_bench_cfg(jax_schema)
    monkeypatch.setattr(jax_schema, "ExperimentConfig", lambda: copy.deepcopy(jcfg))
    monkeypatch.setattr(jax_models, "init_clibd_params", init)
    monkeypatch.setattr(jax_extract, "extract_split",
                        lambda *a, **k: jax_out.append(real_jax_extract(*a, **k)) or jax_out[-1])
    monkeypatch.setattr(sys, "argv", ["bench_extract", "12", "8", "0"])
    _script("bench_extract").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    pcfg = _tiny_port_bench_cfg()
    model = model_from_jax(trees[0], pcfg, "cpu")
    monkeypatch.setattr(bench_extract, "flagship_config", lambda: pcfg)
    monkeypatch.setattr(port_clibd, "init_clibd_model", lambda cfg, gen, device: model)
    monkeypatch.setattr(port_extract, "extract_split",
                        lambda *a, **k: port_out.append(real_port_extract(*a, **k))
                        or port_out[-1])
    for name in ("WARMUP", "ITERS", "PASSES"):
        monkeypatch.setattr(bench_mod, name, 1)
    got = bench_extract.run(n_records=12, batch=8, workers=0, device="cpu")
    for key in ("records", "batch", "num_workers", "native_decoder"):
        assert got[key] == want[key], key
    j, p = jax_out[-1], port_out[-1]
    for key in ("label_list", "file_name_list"):
        assert list(p[key]) == list(j[key]), key
    for key in ("encoded_image_feature", "encoded_dna_feature"):
        assert p[key].shape == (12, pcfg.output_dim), key
        err, scale = float(np.abs(p[key] - j[key]).max()), float(np.abs(j[key]).max())
        assert err <= 2e-2 * scale, (key, err, scale)


def test_bench_pipeline_rows(tmp_path):
    from clibd_tpu_torch.tools.fixtures import make_tiny_bioscan_hdf5

    path = str(tmp_path / "f.hdf5")
    make_tiny_bioscan_hdf5(path, n_per_split=24, splits=("no_split_and_seen_train",))
    rows = bench_pipeline.run(path, batch=8)
    names = [r["name"] for r in rows]
    assert names[:2] == ["python+PIL, 0 workers", "python+PIL, 4 workers"]
    assert all(r["images"] == 24 and r["images_per_s"] > 0 for r in rows)


def test_the_fixture_is_the_jax_tests_copy(tmp_path):
    import h5py

    from clibd_tpu_torch.tools.fixtures import make_tiny_bioscan_hdf5
    from tests.fixtures import make_tiny_bioscan_hdf5 as jax_fixture

    a, b = str(tmp_path / "a.hdf5"), str(tmp_path / "b.hdf5")
    make_tiny_bioscan_hdf5(a, n_per_split=5, splits=("test_seen", "all_keys"), image_hw=(64, 64))
    jax_fixture(b, n_per_split=5, splits=("test_seen", "all_keys"), image_hw=(64, 64))
    with h5py.File(a) as fa, h5py.File(b) as fb:
        for split in fb:
            for name in fb[split]:
                np.testing.assert_array_equal(fa[split][name][:], fb[split][name][:])


def test_bench_decode_names_its_library():
    rows = bench_decode.run(n=8)
    assert len(rows) == 6 and all(r["images_per_s"] > 0 for r in rows)
    assert rows[0]["library"].endswith(".so")
