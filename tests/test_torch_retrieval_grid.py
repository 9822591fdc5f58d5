"""`eval`'s retrieval grids and similarity distributions, and `failure-cases`,
in the port against clibd_tpu on the CPU, on the HDF5 fixture from one
weight set (seeded, in the JAX package's layout as an .npz, named by
model_config.ckpt_path on both sides), fp32.

- The port's own `eval --device cpu` (extraction included) writes the record
  JSON and the distance CSV that the JAX command's eval writes from the same
  embeddings (the port's cache, load_inference), byte for byte, and the same
  figures.  The extraction itself is held against the JAX package's, with
  its Pallas attention in interpret mode, in test_torch_extract_eval.py.
- The port's eval from that cache (load_inference) writes the same bytes.
- On the cache's dicts, `retrieve_images_multi` (only_failures, the
  combined figure, other k, queries and seed) and the single-pair
  `retrieve_images` write the JAX package's record JSON byte for byte.
- `find_failures` on the cache's dicts gives the JAX package's cases for
  every pair and split, and `failure-cases --device cpu` over that cache
  writes the same files.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from clibd_tpu.cli import main as jax_main
from clibd_tpu.config import load_config as jax_load_config
from clibd_tpu.analysis import failure_cases as jax_failure_cases
from clibd_tpu.engine import retrieval_grid as jax_grid
from clibd_tpu.models import init_clibd_params
from clibd_tpu.models.convert import save_params_npz
from clibd_tpu_torch import cli as port_cli
from clibd_tpu_torch.analysis import failure_cases as port_failure_cases
from clibd_tpu_torch.engine import retrieval_grid as port_grid
from clibd_tpu_torch.engine.extract import load_extracted_features
from tests.torch_tiny import numpy_params

GRID_EXP = """
model_output_name: tiny_grid
dataset: bioscan_1m
batch_size: 12
output_dim: 16
amp: false
disable_lora: true
default_seed: 42
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 32, num_layers: 2, num_heads: 4,
        mlp_dim: 64}
dna:
  bert: {vocab_size: 1027, hidden_size: 32, num_layers: 2, num_heads: 4, intermediate_size: 64,
         max_position_embeddings: 140, with_mlm_head: true}
language:
  enable: false
"""
FOLDER = os.path.join("extracted_embedding", "bioscan_1m", "tiny_grid")
GRID_ON = ["inference_and_eval_setting.retrieve_images=true",
           "inference_and_eval_setting.similarity_distributions=true",
           "inference_and_eval_setting.plot_embeddings=false",
           "inference_and_eval_setting.retrieve_settings.num_queries=3",
           "inference_and_eval_setting.retrieve_settings.max_k=2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, its module fixtures included: the
    suite runs six files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval(main, root, hdf5, *extra):
    """One `eval` with the working directory at `root` (the reports go to
    ./logs)."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert main(["eval", "-e", str(root.parent / "exp.yaml"), "--hdf5", hdf5, *extra,
                     f"project_root_path={root}", "pipeline.num_workers=0",
                     "pipeline.use_native_decoder=false", "model_config.load_ckpt=true",
                     f"model_config.ckpt_path={root.parent / 'params.npz'}", *GRID_ON]) == 0
    finally:
        os.chdir(cwd)
    return root / FOLDER


@pytest.fixture(scope="module")
def port_run(tiny_hdf5, tmp_path_factory):
    """The port's eval on the fixture, extraction included: its embedding
    cache and its outputs."""
    base = tmp_path_factory.mktemp("grid")
    (base / "exp.yaml").write_text(GRID_EXP)
    mc = jax_load_config(experiment=str(base / "exp.yaml")).model_config
    # the blocks scaled apart: at N(0, 0.02) every image maps to nearly one
    # direction, and the ranks of the retrieved keys are decided by near-ties
    # that the two packages' searches may break either way
    save_params_npz(numpy_params(lambda key: init_clibd_params(key, mc), 32, block_std=0.2),
                    str(base / "params.npz"))
    root = base / "port"
    root.mkdir()
    return _eval(port_cli.main, root, tiny_hdf5, "--device", "cpu")


def _from_cache(folder, name):
    """A new project root holding a copy of `folder`'s embedding cache."""
    root = folder.parents[3] / name
    shutil.copytree(folder.parents[1], root / "extracted_embedding")
    return root


@pytest.fixture(scope="module")
def jax_run(port_run, tiny_hdf5):
    """The JAX command's eval on the port's embedding cache (load_inference)."""
    return _eval(jax_main, _from_cache(port_run, "jax"), tiny_hdf5, "load_inference=true")


@pytest.fixture(scope="module")
def cache(port_run):
    """The embedding cache → (seen, unseen, keys) dicts."""
    return load_extracted_features(str(port_run / "extracted_feature_from_test_split.hdf5"),
                                   str(port_run / "labels_test.json"),
                                   str(port_run / "processed_id_test.json"))


def _figures(folder):
    return sorted(p for p in os.listdir(folder / "retrieval") if p.endswith(".png"))


def _same_outputs(got, want):
    for name in ("retrieval/retrieved_images.json", "similarity_distances.csv"):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    assert _figures(got) == _figures(want) and _figures(got)
    assert (got / "similarity_distributions.png").stat().st_size > 0


def test_eval_from_the_cache_writes_what_jax_writes(jax_run, tiny_hdf5):
    """The port's eval on the embedding cache (load_inference) writes the
    JAX command's record JSON and distance CSV byte for byte."""
    got = _eval(port_cli.main, _from_cache(jax_run, "port_cache"), tiny_hdf5, "--device", "cpu",
                "load_inference=true")
    _same_outputs(got, jax_run)


@pytest.mark.parametrize("settings", [dict(only_failures=True, independent=False, max_k=2),
                                      dict(independent=True, max_k=4, seed=5)])
def test_retrieve_images_multi_options_match_jax(cache, tiny_hdf5, tmp_path, settings):
    """`retrieve_images_multi`'s options (only_failures, the combined figure,
    other k, queries and seed) on the cache's dicts: the JAX package's record
    JSON byte for byte, and the same figures."""
    seen, _unseen, keys = cache
    pairs = [("encoded_dna_feature", "encoded_dna_feature"),
             ("encoded_image_feature", "encoded_dna_feature")]
    out = {}
    for name, run, extra in (("jax", jax_grid.retrieve_images_multi, {}),
                             ("port", port_grid.retrieve_images_multi, {"device": "cpu"})):
        res = run(str(tmp_path / name), tiny_hdf5, "test_seen", "all_keys", seen, keys,
                  query_keys=pairs, num_queries=2, **settings, **extra)
        out[name] = ((tmp_path / name / "retrieved_images.json").read_bytes(),
                     sorted(os.path.basename(p) for p in res["figures"]))
    assert out["port"] == out["jax"] and out["port"][1]


def test_retrieve_images_matches_jax(cache, tiny_hdf5, tmp_path):
    """The single-pair `retrieve_images` on the cache's dicts, DNA queries
    against image keys: the JAX package's record JSON byte for byte, its
    record and a figure."""
    seen, _unseen, keys = cache
    qf, kf = "encoded_dna_feature", "encoded_image_feature"
    out = {}
    for name, run, extra in (("jax", jax_grid.retrieve_images, {}),
                             ("port", port_grid.retrieve_images, {"device": "cpu"})):
        res = run(str(tmp_path / name), tiny_hdf5, "test_seen", "all_keys", seen[qf], keys[kf],
                  seen["label_list"], keys["label_list"], num_queries=4, max_k=3, seed=7,
                  name="grid", **extra)
        assert os.path.getsize(res["figure"]) > 0
        out[name] = ((tmp_path / name / "grid.json").read_bytes(), res["record"])
    assert out["port"] == out["jax"] and len(out["port"][1]) == 4


def test_eval_extracting_matches_jax(port_run, jax_run):
    """The port's eval, its own extraction included, writes the record JSON
    and the distance CSV that the JAX command writes from the same
    embeddings, byte for byte, and the same figures; its records sample
    queries and retrieve keys for every pair of both modalities."""
    _same_outputs(port_run, jax_run)
    with open(port_run / "retrieval" / "retrieved_images.json") as f:
        payload = json.load(f)
    assert len(payload["query_keys"]) == 4 and len(payload["results"]) == 3
    assert all(len(c["predictions"]) == 2 for r in payload["results"] for c in r["results"])


def test_failure_cases_matches_jax(port_run, cache, tiny_hdf5, tmp_path):
    """`find_failures` on the cache's dicts: the JAX package's cases, all of
    them, for every pair of `failure-cases` and both query splits; and the
    command over the cache writes the JAX command's files."""
    seen, unseen, keys = cache
    n_cases = 0
    for queries in (seen, unseen):
        for qf, kf in port_failure_cases.QUERY_AND_KEY_WE_CARE_ABOUT:
            want = jax_failure_cases.find_failures(queries, keys, qf, kf, max_cases=100)
            got = port_failure_cases.find_failures(queries, keys, qf, kf, max_cases=100,
                                                   device="cpu")
            assert got == want and len(got) < 100, (qf, kf)
            n_cases += len(got)
    assert n_cases > 0
    paths = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        out = tmp_path / name
        assert main(["failure-cases", "--features",
                     str(port_run / "extracted_feature_from_test_split.hdf5"),
                     "--labels", str(port_run / "labels_test.json"),
                     "--ids", str(port_run / "processed_id_test.json"), "--hdf5", tiny_hdf5,
                     "--out", str(out), "--max-cases", "1", *extra]) == 0
        paths[name] = sorted(os.path.relpath(os.path.join(d, f), out)
                             for d, _, files in os.walk(out) for f in files)
    assert paths["port"] == paths["jax"] and paths["port"]


def test_searches_go_to_the_given_device():
    """`retrieval_records` and `find_failures` run their searches on the
    device they are given and on the CPU give what the CPU search gives."""
    rng = np.random.default_rng(33)
    labels = [{lv: f"{lv}{i % 3}" for lv in ("order", "family", "genus", "species")}
              for i in range(20)]
    feats = rng.standard_normal((20, 8)).astype(np.float32)
    keys = {"encoded_image_feature": feats, "label_list": labels,
            "processed_id_list": [f"k{i}" for i in range(20)]}
    queries = {"encoded_image_feature": feats[:10] + 0.5 * rng.standard_normal((10, 8)).astype(
        np.float32), "label_list": labels[:10], "processed_id_list": [f"q{i}" for i in range(10)]}
    pairs = [("encoded_image_feature", "encoded_image_feature")]
    indices, results = port_grid.retrieval_records(queries, keys, pairs, num_queries=4, max_k=3,
                                                   device="cpu")
    assert len(indices) == len(results) == 4
    assert all(len(r["results"][0]["predictions"]) == 3 for r in results)
    cases = port_failure_cases.find_failures(queries, keys, *pairs[0], device="cpu")
    assert all(c["gt_species"] != c["pred_species"] for c in cases)
    with pytest.raises((AssertionError, RuntimeError)):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        port_grid.retrieval_records(queries, keys, pairs, num_queries=4)
