"""The port's INSECT path on the CPU: `data/insect.py`'s dataset and loader
against the JAX package's bit for bit, and `python -m clibd_tpu_torch.cli
train` on a tiny INSECT config -- an epoch with its eval over the
trainval / test_seen / test_unseen splits, last/ and best/ written, and
`--resume` from a last/ that the JAX package wrote.  The INSECT files are
made here from a generator seeded in this file (the layout of
tests/test_splits_insect_fusion.py's fixture).
"""

import json

import numpy as np
import pytest
import torch

import jax

from clibd_tpu.config import load_config as jax_load_config
from clibd_tpu.data import insect as jax_insect
from clibd_tpu.data.pipeline import BatchSpec as JaxBatchSpec
from clibd_tpu.engine import checkpoint as jax_checkpoint
from clibd_tpu.engine import schedules as jax_schedules
from clibd_tpu.engine import train as jax_train
from clibd_tpu.models import init_clibd_params
from clibd_tpu_torch import cli as port_cli
from clibd_tpu_torch.data import insect as port_insect
from clibd_tpu_torch.data.pipeline import BatchSpec as PortBatchSpec
from tests.fixtures import random_jpeg_bytes

N = 20


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the tiny model's ops gain
    nothing from more, and the suite's workers would oversubscribe the
    cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def insect_files(tmp_path_factory):
    import h5py
    import scipy.io as sio

    root = tmp_path_factory.mktemp("insect")
    rng = np.random.default_rng(1234)
    ids = np.array([[f"im{i}"] for i in range(N)], dtype=object)
    barcodes = np.array([["".join(rng.choice(list("ACGT"), 120 + i))] for i in range(N)],
                        dtype=object)
    species = np.array([[f"sp{i % 5}"] for i in range(N)], dtype=object)
    sio.savemat(str(root / "res101.mat"), {"ids": ids, "nucleotides": barcodes,
                                           "species": species,
                                           "labels": (np.arange(N) % 5 + 1).reshape(-1, 1)})
    sio.savemat(str(root / "att_splits.mat"), {
        "trainval_loc": np.arange(1, 13).reshape(1, -1),
        "test_seen_loc": np.arange(13, 17).reshape(-1, 1),  # a column vector
        "test_unseen_loc": np.arange(17, 21).reshape(1, -1),
    })
    with h5py.File(str(root / "images.hdf5"), "w") as f:
        g = f.create_group("images")
        for i in range(N):
            g.create_dataset(f"im{i}", data=np.frombuffer(random_jpeg_bytes(rng), dtype=np.uint8))
    s2o = {f"sp{i}": {"order": f"o{i % 2}", "family": f"f{i}", "genus": f"g{i}"}
           for i in range(5)}
    del s2o["sp3"]["genus"]  # a missing level → not_classified
    (root / "s2o.json").write_text(json.dumps(s2o))
    return root


def _dataset(mod, root, split):
    return mod.INSECTDataset(str(root / "att_splits.mat"), str(root / "res101.mat"),
                             str(root / "images.hdf5"), str(root / "s2o.json"), split=split)


def _same(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b), what


@pytest.mark.parametrize("split,train", [("trainval_loc", True), ("test_seen_loc", False),
                                         ("test_unseen_loc", False)])
def test_loader_batches_equal_jax(insect_files, split, train):
    jds, pds = _dataset(jax_insect, insect_files, split), _dataset(port_insect, insect_files, split)
    assert pds.label_dicts() == jds.label_dicts() and pds.text_strings == jds.text_strings
    kw = dict(batch_size=4, train=train, with_language=False)
    jl = jax_insect.INSECTLoader(jds, JaxBatchSpec(**kw), seed=42)
    pl = port_insect.INSECTLoader(pds, PortBatchSpec(**kw), seed=42)
    assert len(pl) == len(jl) and pl.ids() == jl.ids()
    for epoch in (0, 1):
        jb, pb = list(jl.batches(epoch=epoch)), list(pl.batches(epoch=epoch))
        assert len(pb) == len(jb) > 0
        for i, (a, b) in enumerate(zip(jb, pb)):
            _same(dict(a), dict(b), f"epoch {epoch} batch {i}")
    last = len(jl) - 1  # the mid-epoch resume's entry: the stream from a batch on
    _same(dict(next(jl.batches(start_batch=last))), dict(next(pl.batches(start_batch=last))),
          "resume")
    jl.close()
    pl.close()


TINY_INSECT_EXP = """
model_output_name: tiny_insect
dataset: INSECT
batch_size: 4
epochs: {epochs}
evaluation_period: 1
eval_skip_epoch: -1
output_dim: 32
disable_lora: true
amp: false
default_seed: 42
image:
  vit: {{image_size: 224, patch_size: 32, hidden_size: 64, num_layers: 2, num_heads: 2,
        mlp_dim: 128}}
dna:
  bert: {{vocab_size: 1027, hidden_size: 64, num_layers: 2, num_heads: 2,
         intermediate_size: 128, max_position_embeddings: 140, with_mlm_head: true}}
language:
  bert: {{vocab_size: 300, hidden_size: 64, num_layers: 2, num_heads: 2,
         intermediate_size: 128, max_position_embeddings: 24}}
"""


def _train_args(root, exp, out, *extra):
    return ["train", "-e", str(exp), "--device", "cpu", "--output-dir", str(out), *extra,
            f"insect_data.path_to_att_splits_mat={root / 'att_splits.mat'}",
            f"insect_data.path_to_res_101_mat={root / 'res101.mat'}",
            f"insect_data.path_to_image_hdf5={root / 'images.hdf5'}",
            f"insect_data.species_to_other={root / 's2o.json'}"]


def test_cli_train_on_insect(insect_files, tmp_path, capsys):
    """`train --device cpu` on the INSECT files: one epoch of 3 steps over
    trainval_loc, an eval over trainval / test_seen / test_unseen, last/ and
    best/ written."""
    exp = tmp_path / "tiny_insect.yaml"
    exp.write_text(TINY_INSECT_EXP.format(epochs=1))
    out = tmp_path / "run"
    assert port_cli.main(_train_args(insect_files, exp, out)) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["best_epoch"] == 0 and np.isfinite(result["final_loss"])
    for f in ("last/params.npz", "last/opt_state.npz", "best/meta.json", "config.yaml"):
        assert (out / f).exists(), f
    best = json.loads((out / "best" / "meta.json").read_text())
    assert best["step"] == 3 and 0.0 <= best["overall_acc"] <= 100.0


def test_cli_train_on_insect_resumes_a_jax_checkpoint(insect_files, tmp_path, capsys):
    """`train --resume DIR` from a last/ that the JAX package wrote (its
    params and its optax state after one epoch's 3 updates): the port goes
    on from epoch 1 and, after its 3 updates, writes a last/ whose optax
    state the JAX package loads back."""
    exp = tmp_path / "tiny_insect.yaml"
    exp.write_text(TINY_INSECT_EXP.format(epochs=2))
    jcfg = jax_load_config(experiment=str(exp)).model_config
    params = init_clibd_params(jax.random.PRNGKey(3), jcfg)
    opt = jax_train.build_optimizer(jcfg, params,
                                    jax_schedules.build_schedule(jcfg.optim, 6, jcfg.batch_size))
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jax.numpy.full_like(p, 1e-3), params)
    for _ in range(3):
        updates, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    jax_checkpoint.save_train_state(str(tmp_path / "jax" / "last"), params, state, step=3,
                                    epoch=0)
    out = tmp_path / "run"
    assert port_cli.main(_train_args(insect_files, exp, out, "--resume",
                                     str(tmp_path / "jax" / "last"))) == 0
    assert "at epoch 1" in capsys.readouterr().out
    meta = json.loads((out / "last" / "meta.json").read_text())
    assert meta["step"] == 6 and meta["epoch"] == 1
    _, loaded, _ = jax_checkpoint.load_train_state(str(out / "last"), opt_state_like=opt.init(params))
    counts = [np.asarray(x) for x in jax.tree.leaves(loaded) if np.asarray(x).dtype == np.int32]
    assert counts and all(int(c) == 6 for c in counts)
    assert torch.isfinite(torch.from_numpy(np.load(out / "last" / "params.npz")[
        "image_encoder/head/w"])).all()
