"""`bzsl-extract` in the port against clibd_tpu on the CPU: both commands
over one INSECT fixture from one weight set (the JAX package's params as an
.npz, named by model_config.ckpt_path on both sides), fp32, the JAX
package's attention through its Pallas kernel in interpret mode.  The two
BZSL CSVs agree row for row, and both commands print the same paths.  Every
input comes from a generator seeded here.
"""

import json

import numpy as np
import pytest
import torch

import jax

from clibd_tpu.cli import main as jax_main
from clibd_tpu.config import load_config as jax_load_config
from clibd_tpu.models import init_clibd_params
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.models.convert import save_params_npz
from clibd_tpu_torch import cli as port_cli
from tests.fixtures import random_jpeg_bytes

CSV_ATOL = 1e-5
N = 12

BZSL_EXP = """
model_output_name: tiny_bzsl
dataset: INSECT
batch_size: 4
output_dim: 16
amp: false
disable_lora: true
default_seed: 42
language: {enable: false}
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 32, num_layers: 2, num_heads: 4,
        mlp_dim: 64}
dna:
  bert: {vocab_size: 1027, hidden_size: 32, num_layers: 2, num_heads: 4, intermediate_size: 64,
         max_position_embeddings: 140, with_mlm_head: true}
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the suite's workers would
    oversubscribe the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def insect_root(tmp_path_factory):
    """tests/test_cli.py's bzsl-extract fixture: 12 records of 3 species,
    INSECT's .mat files and a JPEG HDF5, and the experiment YAML."""
    import h5py
    import scipy.io as sio

    root = tmp_path_factory.mktemp("bzsl")
    rng = np.random.default_rng(12)
    sio.savemat(str(root / "res101.mat"), {
        "ids": np.array([[f"im{i}"] for i in range(N)], dtype=object),
        "nucleotides": np.array([[("ACGT" * 30)[: 100 + i]] for i in range(N)], dtype=object),
        "species": np.array([[f"sp{i % 3}"] for i in range(N)], dtype=object),
        "labels": (np.arange(N) % 3 + 1).reshape(-1, 1),
    })
    sio.savemat(str(root / "att_splits.mat"), {
        "trainval_loc": np.arange(1, 9).reshape(1, -1),
        "test_seen_loc": np.arange(9, 11).reshape(1, -1),
        "test_unseen_loc": np.arange(11, N + 1).reshape(1, -1),
    })
    with h5py.File(str(root / "images.hdf5"), "w") as f:
        g = f.create_group("images")
        for i in range(N):
            g.create_dataset(f"im{i}", data=np.frombuffer(random_jpeg_bytes(rng), dtype=np.uint8))
    (root / "s2o.json").write_text(json.dumps(
        {f"sp{i}": {"order": f"o{i % 2}", "family": f"f{i}", "genus": f"g{i}"} for i in range(3)}))
    (root / "exp.yaml").write_text(BZSL_EXP)
    params = init_clibd_params(jax.random.PRNGKey(21),
                               jax_load_config(experiment=str(root / "exp.yaml")).model_config)
    save_params_npz(jax.tree.map(np.asarray, params), str(root / "params.npz"))
    return root


def test_bzsl_extract_matches_jax(insect_root, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(jax_layers, "ATTENTION_IMPL", "pallas")
    root = insect_root
    printed = {}
    for name, run, extra in (("jax", jax_main, []), ("port", port_cli.main, ["--device", "cpu"])):
        project = tmp_path / name
        assert run(["bzsl-extract", "-e", str(root / "exp.yaml"), "--batch-size", "5", *extra,
                    f"project_root_path={project}", "model_config.load_ckpt=true",
                    f"model_config.ckpt_path={root / 'params.npz'}",
                    f"insect_data.path_to_att_splits_mat={root / 'att_splits.mat'}",
                    f"insect_data.path_to_res_101_mat={root / 'res101.mat'}",
                    f"insect_data.path_to_image_hdf5={root / 'images.hdf5'}",
                    f"insect_data.species_to_other={root / 's2o.json'}"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        printed[name] = [ln for ln in lines if ln.endswith(".csv")]
        assert printed[name] == lines[-2:]
        assert [p.replace(str(project), "") for p in printed[name]] == [
            "/extracted_embedding/INSECT/tiny_bzsl/trained_on_BIOSCAN_1M/"
            f"{kind}_embedding_from_bioscan_clip_no_fine_tuned_on_INSECT.csv"
            for kind in ("dna", "image")]
    for (want_path, got_path), shape in zip(zip(printed["jax"], printed["port"]),
                                            ((16, 3), (16, N))):
        want = np.loadtxt(want_path, delimiter=",")
        got = np.loadtxt(got_path, delimiter=",")
        assert got.shape == want.shape == shape
        assert np.isfinite(got).all()
        for row in range(shape[0]):
            np.testing.assert_allclose(got[row], want[row], rtol=0, atol=CSV_ATOL,
                                       err_msg=f"{got_path} row {row}")
