"""`soak_extract`'s stream leg on the CPU against the JAX package's
`tools/soak_extract.py` (imported by path) at the tiny width
(`soak_train.TINY`), on one soak file and one weight set."""

import importlib.util
import os
from pathlib import Path

import pytest
import torch

from clibd_tpu_torch.tools import soak_extract

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_soak_extract_stream_equals_the_jax_scripts(tmp_path, monkeypatch):
    """The JAX script's `stream` leg and the port's over one soak file at the
    tiny width, on the same weights (both commands' `_resolve_params`
    patched; the JAX command given the port's tiny overrides): the same
    datasets, names and labels, and embeddings within bf16 rounding (2e-2
    of the largest)."""
    import h5py
    import numpy as np

    import clibd_tpu.cli as jax_cli
    import clibd_tpu.cli.extract_cmds as jax_extract_cmds
    from clibd_tpu.models import init_clibd_params
    from clibd_tpu_torch.cli import extract_cmds as port_extract_cmds
    from clibd_tpu_torch.models.convert import model_from_jax
    from clibd_tpu_torch.tools import soak_train
    from tests.torch_tiny import numpy_params

    monkeypatch.chdir(tmp_path)  # the commands write logs/ where they run
    p = soak_extract.Paths(str(tmp_path / "work"))
    os.makedirs(p.workdir)
    soak_extract.build(p, "cpu")
    spec = importlib.util.spec_from_file_location("jax_tools_soak_extract",
                                                  REPO / "tools" / "soak_extract.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    monkeypatch.setattr(jmod, "DATA", p.data)
    monkeypatch.setattr(jmod, "ROOT", str(tmp_path / "jax_root"))

    trees = []

    def resolve(cfg):
        trees.append(numpy_params(lambda k: init_clibd_params(k, cfg.model_config), 6))
        return trees[-1]

    tiny = [*soak_train.TINY, f"model_config.batch_size={soak_extract.sizes('cpu')[1]}"]
    real_main = jax_cli.main
    monkeypatch.setattr(jax_cli, "main", lambda argv: real_main(argv + tiny))
    monkeypatch.setattr(jax_extract_cmds, "_resolve_params", resolve)
    jout, pout = tmp_path / "jax_stream.hdf5", tmp_path / "port_stream.hdf5"
    jmod.stream(out=str(jout))
    monkeypatch.setattr(port_extract_cmds, "_resolve_params",
                        lambda cfg, device: model_from_jax(trees[0], cfg.model_config, device))
    assert soak_extract.stream(p, out=str(pout), device="cpu") == 0
    with h5py.File(jout) as fj, h5py.File(pout) as fp:
        assert sorted(fp) == sorted(fj)
        assert fp["file_name"].shape[0] == p.split_sizes()["all_keys"]
        for k in fj:
            want, got = fj[k][:], fp[k][:]
            assert got.shape == want.shape and got.dtype == want.dtype, k
            if want.dtype.kind == "f":
                err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
                assert err <= 2e-2 * scale, (k, err, scale)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
