"""The port's training loop on the CPU: checkpoints in the JAX package's
schema, `Trainer.fit` with last/best checkpoints, resume (mid-epoch
included), the options not ported yet, and `python -m clibd_tpu_torch.cli
train --device cpu` end to end on the tiny HDF5 fixture.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from clibd_tpu.models import init_clibd_params
from clibd_tpu.models.convert import load_params_npz as jax_load_params_npz
from clibd_tpu_torch.config import schema as port_schema
from clibd_tpu_torch.data import SyntheticSplit
from clibd_tpu_torch.engine import train as port_train
from clibd_tpu_torch.engine.checkpoint import load_train_state, save_train_state
from clibd_tpu_torch.models import model_from_jax
from tests.torch_tiny import port_tiny_cfg, tiny_cfg

REPO = Path(__file__).resolve().parents[1]


def test_params_npz_is_read_by_jax(tmp_path):
    """A checkpoint the port writes is the JAX package's params.npz: its
    loader reads every leaf back unchanged."""
    cfg = port_tiny_cfg()
    model = model_from_jax(jax.tree.map(np.asarray, init_clibd_params(jax.random.PRNGKey(8),
                                                                     tiny_cfg())), cfg, "cpu")
    save_train_state(str(tmp_path / "ck"), model, None, step=3, epoch=1, meta={"x": 1})
    tree = jax_load_params_npz(str(tmp_path / "ck" / "params.npz"))
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}
    state = dict(model.named_parameters())
    assert set(flat) == set(state)
    for n, p in state.items():
        assert np.array_equal(flat[n], p.detach().numpy()), n
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta == {"step": 3, "epoch": 1, "x": 1}
    assert not (tmp_path / "ck" / "opt_state.npz").exists()


def _trainer(tmp_path, splits, cfg_over=None):
    gcfg = port_schema.GlobalConfig()
    gcfg.model_config = port_tiny_cfg(batch_size=4, epochs=2, disable_lora=True,
                                      **(cfg_over or {}))
    return port_train.Trainer(gcfg, None, str(tmp_path / "out"), train_loader=splits["train"],
                              eval_loader_factory=lambda split, train: splits[split],
                              device="cpu")


@pytest.fixture(scope="module")
def splits():
    cfg = port_tiny_cfg(batch_size=4)
    return {n: SyntheticSplit(n, k, cfg, seed=i) for i, (n, k) in
            enumerate({"train": 12, "all_keys": 8, "val_seen": 4, "val_unseen": 4}.items())}


def test_fit_writes_last_and_best_and_resume_restores_everything(tmp_path, splits):
    """fit → last/ and best/; a fresh trainer resumed from a mid-epoch
    checkpoint has the step, the AdamW state, the best metric and the batch
    to start at inside the epoch."""
    trainer = _trainer(tmp_path, splits, {"checkpoint_every_steps": 4})
    history = trainer.fit()
    trainer.close()
    assert len(history["loss"]) == 2 and all(np.isfinite(history["loss"]))
    assert len(history["overall_acc"]) == 2 and history["best_epoch"] is not None
    out = tmp_path / "out"
    for sub in ("last", "best"):
        assert (out / sub / "params.npz").exists() and (out / sub / "opt_state.npz").exists()
    best = json.loads((out / "best" / "meta.json").read_text())
    assert "overall_acc" in best

    # step 4 of 6 is a mid-epoch save (epoch 1, batch 1): meta.epoch = 0
    mid = tmp_path / "mid"
    save_train_state(str(mid / "last"), trainer.model, trainer.optimizer, step=4, epoch=0)
    (mid / "best").mkdir()
    (mid / "best" / "meta.json").write_text(json.dumps({"overall_acc": 0.25, "epoch": 0}))
    fresh = _trainer(tmp_path / "fresh", splits)
    assert fresh.resume(str(mid / "last")) == 1
    assert fresh.global_step == 4 and fresh._resume_start_batch == 1
    assert fresh.checkpointer.best_metric == 0.25 and fresh.checkpointer.best_epoch == 0
    assert fresh.optimizer.update_count() == trainer.optimizer.update_count() == 6
    for (n, p), q in zip(trainer.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n
        if p.requires_grad:
            a, b = trainer.optimizer.state[p], fresh.optimizer.state[q]
            assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"],
                                                                           b["exp_avg_sq"])
    # the resumed run goes on from batch 1 of epoch 1: 2 more steps
    fresh.fit(start_epoch=1)
    assert fresh.global_step == 6 and fresh.optimizer.update_count() == 8


def test_resume_rejects_a_foreign_optimizer_state(tmp_path, splits):
    trainer = _trainer(tmp_path, splits)
    save_train_state(str(tmp_path / "ck"), trainer.model, trainer.optimizer, step=0, epoch=-1)
    np.savez(tmp_path / "ck" / "opt_state.npz", other=np.zeros(1))
    with pytest.raises(ValueError, match="do not match"):
        load_train_state(str(tmp_path / "ck"), trainer.model, trainer.optimizer)


def test_options_not_ported_raise_in_training(tmp_path, splits):
    """The multi-device options, once raising, run on one process: the
    gradient cache; `step_impl: shard_map` takes the multi-rank step, whose
    update at W=1 is the global step's with the generator folded with rank
    0 (bit for bit: no collective runs outside a group); and
    `resume_multihost` is `resume` where the checkpoint exists, None where
    it does not (tests/test_torch_multirank.py holds both at W=2)."""
    assert _trainer(tmp_path, splits, {"accum_steps": 2}).step_fn is not None
    sharded = _trainer(tmp_path / "s", splits, {"step_impl": "shard_map"})
    plain = _trainer(tmp_path / "p", splits)
    plain.model.load_state_dict(sharded.model.state_dict())
    batch = port_train.to_device(next(splits["train"].batches()), torch.device("cpu"))
    batch = {k: batch[k] for k in ("image", "dna", "language", "label")}
    gen = port_train.batch_generator(torch.device("cpu"), 0, 0, 0)
    loss_s = sharded.step_fn(batch, gen)
    loss_p = plain.step_fn(batch, port_train.fold_in(gen, 0))
    assert torch.equal(loss_s, loss_p)
    for (n, p), q in zip(sharded.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p, q), n
    assert sharded.resume_multihost(str(tmp_path / "none")) is None
    save_train_state(str(tmp_path / "ck"), sharded.model, sharded.optimizer, step=3, epoch=0)
    assert plain.resume_multihost(str(tmp_path / "ck")) == 1 and plain.global_step == 3
    for (n, p), q in zip(sharded.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p, q), n


TINY_TRAIN_EXP = """
model_output_name: tiny_torch_train
dataset: bioscan_1m
batch_size: 5
epochs: 1
output_dim: 32
disable_lora: true
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


def test_cli_train_end_to_end(tiny_hdf5, tmp_path):
    """`python -m clibd_tpu_torch.cli train --device cpu` on the fixture for
    one epoch: trains, evaluates, writes last/ and best/ and the config, and
    the port's `eval` would find the result."""
    exp = tmp_path / "tiny.yaml"
    exp.write_text(TINY_TRAIN_EXP)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "clibd_tpu_torch.cli", "train", "-e", str(exp), "--device", "cpu",
         "--hdf5", tiny_hdf5, "--output-dir", str(out), "pipeline.num_workers=0",
         "pipeline.use_native_decoder=false"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["best_epoch"] == 0 and np.isfinite(result["final_loss"])
    for f in ("last/params.npz", "last/opt_state.npz", "best/meta.json", "config.yaml"):
        assert (out / f).exists(), f
    tree = jax_load_params_npz(str(out / "best" / "params.npz"))
    assert tree["image_encoder"]["blocks"]["qkv_w"].shape == (2, 128, 384)
