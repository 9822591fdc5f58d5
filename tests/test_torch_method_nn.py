"""`method-nn` in the port against clibd_tpu on the CPU: both commands on the
HDF5 fixture from one weight set (the JAX package's params as an .npz,
named by model_config.ckpt_path on both sides), fp32, each package's
attention as its commands run it on the CPU (the JAX package's XLA path, the
port's plain version).  Plain method_nn and `--linear` (the frozen probe,
both fits from the JAX package's initial draw) give the same threshold and
accuracies within one query's share; `--linear --probe full` is held for its
structure (its training loader draws augmentation; its step is held by
tests/test_torch_finetune.py).  The engine function is driven with a
factory of in-memory splits too.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.cli import main as jax_main
from clibd_tpu.config import load_config as jax_load_config
from clibd_tpu.models import init_clibd_params
from clibd_tpu.models.convert import save_params_npz
from clibd_tpu_torch import cli as port_cli
from clibd_tpu_torch.engine import fusion as port_fusion

QUERIES = 12  # rows of each query split of the fixture

METHOD_NN_EXP = """
model_output_name: tiny_method_nn
dataset: bioscan_1m
batch_size: 4
output_dim: 16
amp: false
disable_lora: true
default_seed: 42
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 32, num_layers: 1, num_heads: 4,
        mlp_dim: 64}
dna:
  bert: {vocab_size: 1027, hidden_size: 32, num_layers: 1, num_heads: 4, intermediate_size: 64,
         max_position_embeddings: 140, with_mlm_head: true}
language:
  bert: {vocab_size: 2000, hidden_size: 16, num_layers: 1, num_heads: 2, intermediate_size: 32,
         max_position_embeddings: 24}
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
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("method_nn")
    (root / "exp.yaml").write_text(METHOD_NN_EXP)
    params = init_clibd_params(jax.random.PRNGKey(8),
                               jax_load_config(experiment=str(root / "exp.yaml")).model_config)
    save_params_npz(jax.tree.map(np.asarray, params), str(root / "params.npz"))
    return root


def _run(main, root, hdf5, extra, capsys):
    assert main(["method-nn", "-e", str(root / "exp.yaml"), "--hdf5", hdf5, *extra,
                 "pipeline.num_workers=0", "pipeline.use_native_decoder=false",
                 "inference_and_eval_setting.eval_on=test", "model_config.load_ckpt=true",
                 f"model_config.ckpt_path={root / 'params.npz'}"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_probe_init(d, num_classes, seed=0):
    """The JAX package's initial probe draw (`train_linear_probe`)."""
    w = 0.01 * jax.random.normal(jax.random.PRNGKey(seed), (d, num_classes), jnp.float32)
    return np.asarray(w), np.zeros(num_classes, np.float32)


@pytest.mark.parametrize("variant", [["--side-b-query", "dna",
                                      "--unseen-keys-split", "unseen_keys,seen_keys"],
                                     ["--linear", "--probe-steps", "100"]])
def test_method_nn_matches_jax(weights, tiny_hdf5, capsys, monkeypatch, variant):
    monkeypatch.setattr(port_fusion, "init_linear_probe", _jax_probe_init)
    want = _run(jax_main, weights, tiny_hdf5, variant, capsys)
    got = _run(port_cli.main, weights, tiny_hdf5, ["--device", "cpu", *variant], capsys)
    assert set(got) == set(want) == {"best_threshold", "seen_species_top1",
                                     "unseen_species_top1", "seen_routing_top1",
                                     "unseen_routing_top1"}
    assert got["best_threshold"] == want["best_threshold"]
    for key in got:
        assert abs(got[key] - want[key]) <= 1.0 / QUERIES + 1e-9, (key, got, want)


def test_method_nn_full_probe_runs(weights, tiny_hdf5, capsys):
    """`--linear --probe full --device cpu`: the summary's keys, the
    threshold in [0, 1] and every accuracy in [0, 1]."""
    got = _run(port_cli.main, weights, tiny_hdf5,
               ["--device", "cpu", "--linear", "--probe", "full", "--probe-epochs", "1"], capsys)
    assert set(got) == {"best_threshold", "seen_species_top1", "unseen_species_top1",
                        "seen_routing_top1", "unseen_routing_top1"}
    assert all(0.0 <= v <= 1.0 for v in got.values())


def test_method_nn_eval_over_in_memory_splits():
    """`engine.downstream.method_nn_eval` with a factory of `SyntheticSplit`s
    (specimens of disjoint seen and unseen species) for each leg: the
    summary in range, the probes' per-step losses recorded (the frozen
    probe's falling), and the loaders built at the spec's batch size with
    the spec's modalities."""
    from clibd_tpu_torch.config import schema
    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.downstream import method_nn_eval
    from clibd_tpu_torch.models import init_clibd_model
    from tests.torch_tiny import port_tiny_cfg

    mc = port_tiny_cfg(disable_lora=True)
    mc.batch_size = 8
    model = init_clibd_model(mc, torch.Generator().manual_seed(0), "cpu")
    seen = ("val_seen", "test_seen", "seen_keys")
    made = []

    def make_loader(split, spec):
        mods = [m for m, on in (("image", spec.with_image), ("dna", spec.with_dna),
                                ("language", spec.with_language)) if on]
        made.append((split, spec.batch_size, tuple(mods)))
        return SyntheticSplit(split, 20, mc, seed=len(split), species=8,
                              species_range=(0, 4) if split in seen else (4, 8),
                              batch_size=spec.batch_size, modalities=mods)

    assert isinstance(mc, schema.ExperimentConfig)
    for linear, probe in ((False, "frozen"), (True, "frozen"), (True, "full")):
        record = {}
        made.clear()
        summary = method_nn_eval(model, mc, make_loader, eval_on="test", linear=linear,
                                 probe=probe, probe_steps=20, probe_epochs=1, record=record)
        assert 0.0 <= summary["best_threshold"] <= 1.0
        assert all(0.0 <= v <= 1.0 for v in summary.values())
        assert all(b == 8 for _, b, _ in made)
        if probe == "full":
            assert len(record["probe_step_losses"]) == 3  # 20 rows at batch 8
            assert ("seen_keys", 8, ("image",)) in made
        elif linear:
            losses = record["frozen_probe_losses"]
            assert len(losses) == 20 and losses[-1] < losses[0]
        else:
            assert record == {}


def test_synthetic_split_species_ranges_cover_and_specs():
    """`SyntheticSplit`'s options for the engines' loader factories: splits of
    disjoint `species_range`s share no species, `cover_species` puts every
    species of the range in the split, `batch_size` and `modalities` follow
    a loader spec, and an open_clip config's specimens carry CLIP-style ids
    (SOT first, EOT the row's largest)."""
    from clibd_tpu_torch.data import SyntheticSplit
    from tests.torch_tiny import port_tiny_cfg

    mc = port_tiny_cfg()
    seen = SyntheticSplit("s", 30, mc, seed=1, species=12, species_range=(0, 6),
                          cover_species=True, batch_size=7, modalities=("image",))
    unseen = SyntheticSplit("u", 30, mc, seed=2, species=12, species_range=(6, 12))
    names = [{lab["species"] for lab in s.label_dicts()} for s in (seen, unseen)]
    assert names[0] == {f"species_{i}" for i in range(6)} and not names[0] & names[1]
    assert {int(n.split("_")[1]) for n in names[1]} <= set(range(6, 12))
    batches = list(seen.batches())
    assert [len(b["index"]) for b in batches] == [7, 7, 7, 7, 2] and len(seen) == 5
    assert all(set(b) == {"index", "label", "image"} for b in batches)
    with pytest.raises(ValueError):
        SyntheticSplit("x", 4, mc, seed=0, species=12, species_range=(0, 6), cover_species=True)

    mc.backbone = "open_clip"
    mc.clip.image_size, mc.clip.context_length, mc.clip.vocab_size = 32, 12, 100
    clip = SyntheticSplit("c", 9, mc, seed=3, species=4, modalities=("image", "language"))
    b = next(clip.batches())
    ids = b["language"]["input_ids"]
    assert set(b["language"]) == {"input_ids"} and b["image"].shape[1:] == (32, 32, 3)
    assert (ids[:, 0] == 98).all() and (ids.max(axis=1) == 99).all()
