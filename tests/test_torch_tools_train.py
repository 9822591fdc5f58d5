"""The training harnesses of `clibd_tpu_torch/tools/` on the CPU, against
the JAX package's scripts in `tools/` (imported by path, as
tests/test_torch_probes.py does):

- `bench_train`: each cell's config and batch are the JAX script's, the
  remat policies launch the attention kernels (their plain versions here)
  as many times as the sweep's accounting says, an out-of-memory cell is
  reported and the sweep goes on, and only a default cell's failure makes
  the command exit non-zero;
- `rehearse`: its records equal `make_learnable_hdf5`'s file dataset for
  dataset, its loaders yield what `BioscanLoader` yields over that file,
  and the rehearsal runs end to end at a tiny width;
- `soak_train`: its data file and its run config are the JAX script's, and
  a run killed with SIGKILL at a step and resumed gives the uninterrupted
  run's losses bit for bit, at a tiny width.

Every input comes from a generator seeded here or in the scripts.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from clibd_tpu_torch.config import schema as port_schema
from clibd_tpu_torch.data.pipeline import BatchSpec, BioscanLoader
from clibd_tpu_torch.ops import attention as port_attention
from clibd_tpu_torch.tools import bench_train, rehearse, soak_train
from tests.test_learnability import make_learnable_hdf5

REPO = Path(__file__).resolve().parents[1]
# the torch threads of every leg, in this process and in the killed one: the
# CPU's products round by their thread count, and the soak's legs must agree
THREADS = 2


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


class _Captured(Exception):
    pass


def _jax_cell(monkeypatch, batch, policy):
    """The JAX script's config and batch for one cell, caught at its first
    train step (no JAX model is built)."""
    jbt = _script("bench_train")
    seen = {}

    def init(key, cfg):
        seen["cfg"] = cfg
        return {}

    class Opt:
        def init(self, params):
            return None

    def step_factory(cfg, optimizer, *a, **k):
        def step(params, opt_state, batch_data, key):
            seen["batch"] = batch_data
            raise _Captured
        return step

    monkeypatch.setattr(jbt, "init_clibd_params", init)
    monkeypatch.setattr(jbt.train_mod, "build_optimizer", lambda cfg, params, sched: Opt())
    monkeypatch.setattr(jbt.train_mod, "make_train_step", step_factory)
    tri = batch >= 256
    with pytest.raises(_Captured):
        jbt.bench(batch, tri_modal=tri, lora=not tri, remat=True, policy=policy)
    return seen["cfg"], seen["batch"]


@pytest.mark.parametrize("batch,policy", [(128, None), (256, None), (256, "off"),
                                          (256, "dots"), (128, "attn+mlp")])
def test_bench_train_cells_are_the_jax_scripts(monkeypatch, batch, policy):
    jcfg, jbatch = _jax_cell(monkeypatch, batch, policy)
    cfg = bench_train.cell_config(batch, policy)
    for field in ("batch_size", "disable_lora", "lora_rank", "remat", "remat_policy", "amp"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.language.enable == jcfg.language.enable
    assert cfg.image.vit.hidden_size == jcfg.image.vit.hidden_size == 768
    got = bench_train.cell_batch(cfg, "cpu")
    assert set(got) == set(jbatch)
    for key in ("image", "dna", "label"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(jbatch[key]), err_msg=key)
    if cfg.language.enable:
        for key, v in jbatch["language"].items():
            np.testing.assert_array_equal(got["language"][key].numpy(), np.asarray(v))


def _tiny(cfg):
    cfg.image.vit = port_schema.ViTConfig(image_size=224, patch_size=32, hidden_size=32,
                                          num_layers=2, num_heads=2, mlp_dim=64)
    cfg.dna.bert = port_schema.BertConfig(vocab_size=1027, hidden_size=32, num_layers=2,
                                          num_heads=2, intermediate_size=64,
                                          max_position_embeddings=140, with_mlm_head=True)
    cfg.language.bert = port_schema.BertConfig(vocab_size=30522, hidden_size=32, num_layers=1,
                                               num_heads=2, intermediate_size=64,
                                               max_position_embeddings=24)
    cfg.output_dim = 16
    return cfg


def _count_plain_versions(monkeypatch):
    """Each call of a plain version adds to its kernel's launches, as a
    launch of the kernel would on the card."""
    for name, wrapper in (("flash_attention_qkv_reference", port_attention.flash_attention_qkv),
                          ("flash_attention_qkv_bwd_reference",
                           port_attention.flash_attention_qkv_bwd)):
        plain = getattr(port_attention, name)

        def counted(*a, _plain=plain, _wrapper=wrapper, **k):
            _wrapper.launches += 1
            return _plain(*a, **k)

        monkeypatch.setattr(port_attention, name, counted)
    monkeypatch.setattr(port_attention.flash_attention_qkv, "launches", 0)
    monkeypatch.setattr(port_attention.flash_attention_qkv_bwd, "launches", 0)


@pytest.mark.parametrize("tri_modal,policy,per_layer", [
    (False, None, 1), (True, "none", 2), (True, "off", 1), (True, "attn+mlp", 1),
    (True, "dots", 2)])
def test_bench_train_launches_follow_the_policy(monkeypatch, tri_modal, policy, per_layer):
    """A cell at a tiny width and batch 8: forward launches of layers x
    steps x `forward_launches_per_layer` (2 where the policy does not save
    the attention's output), backward launches of layers x steps."""
    _count_plain_versions(monkeypatch)
    cfg = _tiny(bench_train.cell_config(256 if tri_modal else 128, policy))
    cfg.batch_size = 8
    r = bench_train.bench(cfg, "cpu", warmup=1, iters=1, passes=1)
    layers = bench_train.attention_layers(cfg)
    assert layers == (5 if tri_modal else 4)
    assert bench_train.forward_launches_per_layer(cfg) == per_layer
    assert port_attention.flash_attention_qkv.launches == layers * r["steps"] * per_layer
    assert port_attention.flash_attention_qkv_bwd.launches == layers * r["steps"]
    assert np.isfinite(r["loss"]) and r["ms"] > 0 and r["peak_gib"] is None


@pytest.mark.parametrize("policy,per_step", [(None, (4 * 2 * 2, 4 * 2)),
                                             ("none", (4 * 2 * 3, 4 * 2))])
def test_bench_train_accum_cell_launches(monkeypatch, policy, per_step):
    """The gradient-cache cell (k=2) at a tiny width and batch 8: every
    layer's forward once a microbatch without grad and once (twice under
    blanket remat) with grad, the backward once a microbatch."""
    _count_plain_versions(monkeypatch)
    cfg = _tiny(bench_train.cell_config(128, policy, accum=2))
    cfg.batch_size = 8
    r = bench_train.bench(cfg, "cpu", warmup=1, iters=1, passes=1)
    assert bench_train.attention_launches(cfg) == per_step
    assert (port_attention.flash_attention_qkv.launches,
            port_attention.flash_attention_qkv_bwd.launches) == tuple(
                n * r["steps"] for n in per_step)
    assert "accum=2" in r["mode"] and np.isfinite(r["loss"])


@pytest.mark.parametrize("argv,failing,rc", [([], 128, 1), (["500", "--policy", "dots"], 500, 0)])
def test_bench_train_reports_oom_and_fails_only_on_a_default_cell(monkeypatch, capsys, argv,
                                                                  failing, rc):
    def bench(cfg, device, **timing):
        if cfg.batch_size == failing:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
        return {"batch": cfg.batch_size, "mode": bench_train.describe(cfg), "ms": 1.0,
                "samples_per_s": 1.0, "loss": 0.0, "peak_gib": None, "steps": 1}

    monkeypatch.setattr(bench_train, "bench", bench)
    assert bench_train.main(["--device", "cpu"] + argv) == rc
    assert f"train step batch {failing} policy" in capsys.readouterr().out


def test_bench_train_lets_other_errors_through(monkeypatch):
    def bench(cfg, device, **timing):
        raise ValueError("not OOM")

    monkeypatch.setattr(bench_train, "bench", bench)
    with pytest.raises(ValueError, match="not OOM"):
        bench_train.sweep([128], [None], [1], "cpu")


@pytest.fixture(scope="module")
def learnable(tmp_path_factory):
    path = tmp_path_factory.mktemp("learnable") / "learnable.hdf5"
    make_learnable_hdf5(str(path), n_per_split=rehearse.N_PER_SPLIT, n_species=rehearse.N_SPECIES)
    return str(path), rehearse.learnable_records()


def test_rehearse_records_equal_the_jax_fixture(learnable):
    path, records = learnable
    with h5py.File(path) as f:
        assert set(f.keys()) == set(records) == set(rehearse.SPLITS)
        for split in rehearse.SPLITS:
            assert set(f[split].keys()) == set(records[split]), split
            for name, data in records[split].items():
                want = f[split][name][:]
                assert want.dtype.kind == np.asarray(data).dtype.kind, (split, name)
                np.testing.assert_array_equal(np.asarray(data), want, err_msg=f"{split}/{name}")


def _same_batches(a, b):
    for x, y in zip(a, b, strict=True):
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], dict):
                for kk in x[k]:
                    np.testing.assert_array_equal(x[k][kk], y[k][kk])
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_rehearse_loaders_yield_what_bioscan_loader_yields_over_the_file(learnable):
    path, records = learnable
    g = rehearse.rehearsal_config(2, 32)
    train, factory = rehearse.make_loaders(records, g, train_workers=0)
    cfg = g.model_config
    spec = train.spec
    over_file = BioscanLoader(path, rehearse.SPLITS[0], spec, num_workers=0,
                              seed=cfg.default_seed, use_native=g.pipeline.use_native_decoder)
    try:
        assert len(train) == len(over_file) == 4
        for epoch in (0, 1):
            _same_batches(train.batches(epoch=epoch), over_file.batches(epoch=epoch))
        for split in ("all_keys", "val_seen"):
            mine = factory(split)
            theirs = BioscanLoader(path, split, BatchSpec.eval_spec(cfg), num_workers=0,
                                   use_native=g.pipeline.use_native_decoder)
            try:
                _same_batches(mine.batches(), theirs.batches())
                assert mine.label_dicts() == theirs.label_dicts()
                assert mine.ids() == theirs.ids()
            finally:
                mine.close()
                theirs.close()
    finally:
        train.close()
        over_file.close()


def test_rehearse_runs_at_a_tiny_width(learnable):
    _, records = learnable

    def configure(g):
        _tiny(g.model_config)
        g.pipeline.num_workers = 0

    out = rehearse.run(epochs=2, batch=32, device="cpu", configure=configure, records=records)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["acc_before"] <= 1.0 and 0.0 <= out["acc_after"] <= 1.0
    assert out["decoder"] in ("native libjpeg pool", "PIL (Python)")


def _soak_run(work, tag, *extra):
    """`soak_train run` in a process of its own, as a user runs it: the
    three runs then share their environment, thread count included."""
    return subprocess.run([sys.executable, "-m", "clibd_tpu_torch.tools.soak_train", "run",
                           "--tag", tag, "--workdir", str(work), "--device", "cpu", *extra],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": str(THREADS)})


def test_soak_train_kill_and_resume_is_bit_exact(tmp_path):
    """build, an uninterrupted run, a run that SIGKILLs itself once step 4
    is logged, its resume from the step-cadence last/, and `compare`: the
    shared steps' losses bit for bit."""
    soak_train.main(["build", "--workdir", str(tmp_path), "--device", "cpu"])
    assert soak_train.sizes("cpu") == (48, 8, 2)
    base = _soak_run(tmp_path, "base")
    assert base.returncode == 0, base.stdout[-2000:] + base.stderr[-2000:]
    summary = json.loads(base.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 6 and summary["device"] == "cpu" and summary["card"] is None
    killed = _soak_run(tmp_path, "killed", "--kill-at", "4")
    assert killed.returncode == -9, killed.stdout[-2000:] + killed.stderr[-2000:]
    assert "SIGKILL at step 4" in killed.stdout
    resumed = _soak_run(tmp_path, "resumed", "--resume")
    assert resumed.returncode == 0, resumed.stdout[-2000:] + resumed.stderr[-2000:]
    assert "resumed: global_step=4" in resumed.stdout
    got = soak_train.compare(str(tmp_path))
    assert got["overlap"] == 2 and got["mismatches"] == [] and got["killed_max"] == 4


def test_soak_train_data_and_config_are_the_jax_scripts(tmp_path, monkeypatch):
    """`build` writes the JAX script's file dataset for dataset (a small
    layout of its splits), and the card's run config is the one the JAX
    script hands its Trainer (captured there; its step log redirected)."""
    import dataclasses

    import clibd_tpu.engine.train as jax_train

    jmod = _script("soak_train")
    splits = (("no_split_and_seen_train", 6), ("val_seen", 3), ("all_keys", 2))
    soak_train.build(str(tmp_path / "port.hdf5"), splits=splits)
    jmod.build(str(tmp_path / "jax.hdf5"), splits=splits)
    with h5py.File(tmp_path / "port.hdf5") as fp, h5py.File(tmp_path / "jax.hdf5") as fj:
        assert sorted(fp) == sorted(fj)
        for split in fj:
            assert sorted(fp[split]) == sorted(fj[split]), split
            for name in fj[split]:
                np.testing.assert_array_equal(fp[split][name][:], fj[split][name][:],
                                              err_msg=f"{split}/{name}")

    seen = []

    def trainer(g, *a, **k):
        seen.append(g)
        raise _Captured

    real_open = open
    monkeypatch.setattr(jax_train, "Trainer", trainer)
    monkeypatch.setattr(jmod, "open", lambda path, mode="r": real_open(
        tmp_path / os.path.basename(path), mode), raising=False)
    with pytest.raises(_Captured):
        jmod.run("base")
    (want,) = seen
    got = soak_train.soak_config("cuda")
    assert got.save_ckpt == want.save_ckpt
    assert dataclasses.asdict(got.model_config) == dataclasses.asdict(want.model_config)
    assert (soak_train.SIZES[0], soak_train.SIZES[1]) == (jmod.N_TRAIN, jmod.BATCH)
