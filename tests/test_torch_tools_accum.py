"""The gradient cache across ranks (`engine/train.py::make_accum_grad_fn(mesh=)`,
`make_train_step_accum(mesh=)`, `Trainer(mesh=)` with accum_steps > 1) on
two gloo ranks on the CPU (`tests/torch_ranks.py`, started once for the
file), the tiny tri-modal model of `tests/torch_tiny.py` in fp32 from one
JAX weight set, the augmentation the identity on both sides:

- at W=2 x k=2 the loss and gradients equal `clibd_tpu`'s
  `make_train_step_accum` on the whole global batch in one process (its
  Pallas attention in interpret mode, as tests/test_torch_accum.py runs
  it), at the bounds the port's train step is held to against JAX, and
  the port's own W=2 monolithic step (`make_sharded_grad_fn`) at the
  gradient cache's bound (see `_hold`);
- `Trainer(mesh=)` at W=2 takes accum_steps=2, fits, and resumes through
  `resume_multihost`; on one process it refuses accum only under
  `step_impl: shard_map`.

Every input is drawn here from a seeded generator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.engine import train as jax_train
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.ops.pallas import attention as jax_attention
from clibd_tpu_torch.config.schema import GlobalConfig
from clibd_tpu_torch.data import SyntheticSplit
from clibd_tpu_torch.engine import train as port_train
from clibd_tpu_torch.models import model_from_jax
from tests.test_torch_accum import GRAD_ATOL, GRAD_COS_MIN, GRAD_RTOL, LOSS_ATOL
from tests.test_torch_train_step import (STEP_GRAD_COS_MIN, STEP_GRAD_REL_TOL, STEP_LOSS_RTOL,
                                         _capture_grads)
from tests.torch_ranks import run_ranks
from tests.torch_tiny import port_tiny_cfg, tiny_cfg, tiny_tree

W, K = 2, 2
B = 8       # the global batch: 4 rows a rank, microbatches of 2
LR = 5e-5


def _batch(seed, rows=B):
    rng = np.random.default_rng(seed)
    att = (rng.random((rows, 20)) > 0.3).astype(np.int32)
    att[:, 0] = 1
    ids = rng.integers(1, 300, (rows, 20)).astype(np.int32) * att
    return {"image": rng.integers(0, 256, (rows, 32, 32, 3), dtype=np.uint8),
            "dna": rng.integers(0, 1027, (rows, 17)).astype(np.int32),
            "language": {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                         "attention_mask": att},
            "label": rng.integers(0, 5, rows)}


def _batches():
    return [_batch(s) for s in (21, 22)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg = port_tiny_cfg(disable_lora=True)
    data = {"cfg": cfg, "state": model_from_jax(tiny_tree(), cfg, "cpu").state_dict(),
            "accum_k": K, "accum_batches": _batches(), "lr": LR,
            "trainer_cfg": port_tiny_cfg(disable_lora=True, batch_size=4, epochs=1,
                                         checkpoint_every_steps=1),
            "trainer_rows": {"train": 16}}
    tmp = tmp_path_factory.mktemp("accum_ranks")
    return tmp, run_ranks(W, ["accum_step", "accum_trainer"], data, tmp)


def _hold(got: dict, want: dict, what: str, rel=GRAD_RTOL, cos_min=GRAD_COS_MIN):
    """Per tensor: max |got - want| <= GRAD_ATOL + rel * max |want|, and the
    cosine >= cos_min.  The gradient cache's bound is taken against each
    tensor's largest entry, not entry by entry: the text tower's
    token_type gradient, a sum over every token, differs by 1.47e-5 (of a
    largest entry of 1.87) between four microbatches of 2 rows and one
    batch of 8, in one process as across two ranks."""
    assert set(got) == set(want), what
    for n, w in want.items():
        g = torch.from_numpy(np.array(got[n], np.float64))
        w = torch.from_numpy(np.array(w, np.float64))
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= GRAD_ATOL + rel * scale, (what, n, err, scale)
        if scale > 0:
            cos = float((g * w).sum() / (g.norm() * w.norm()))
            assert cos >= cos_min, (what, n, cos)


def _flat(tree) -> dict:
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_ranks_agree(ranks):
    """Every rank holds the same loss and gradients, bit for bit."""
    _, out = ranks
    for o in out[1:]:
        for name in ("accum", "mono"):
            for mine, theirs in zip(o["accum_step"][name], out[0]["accum_step"][name]):
                assert torch.equal(mine["loss"], theirs["loss"])
                assert set(mine["grads"]) == set(theirs["grads"])
                for n, g in mine["grads"].items():
                    assert torch.equal(g, theirs["grads"][n]), (name, n)


@pytest.mark.parametrize("step", [0, 1])
def test_accum_across_ranks_equals_the_multirank_monolithic_step(ranks, step):
    """k=2 microbatches a rank against `make_sharded_grad_fn` on the same
    rows: the loss within LOSS_ATOL, every gradient (logit_scale's among
    them) within the gradient cache's bound."""
    _, out = ranks
    got, want = out[0]["accum_step"]["accum"][step], out[0]["accum_step"]["mono"][step]
    assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_ATOL
    assert "logit_scale" in got["grads"]
    _hold(got["grads"], want["grads"], f"step {step}")


@pytest.mark.parametrize("step", [0, 1])
def test_accum_across_ranks_equals_jax_on_the_global_batch(ranks, monkeypatch, step):
    """The W=2 x k=2 loss and gradients against `clibd_tpu`'s
    `make_train_step_accum` (k=2) on the whole batch of 8 rows in one
    process, from one weight set, at the bounds the port's train step is
    held to against JAX (tests/test_torch_train_step.py: the two attention
    paths round P to bf16 at other points): neither W times nor 1/W times
    the global batch's gradient, whose norms agree within 1e-3.  (The
    params after an AdamW update are not compared: AdamW normalises each
    element, so where a gradient is float noise around zero the two
    packages' updates lie up to 2 lr apart.)"""
    monkeypatch.setattr(jax_layers, "ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(jax_attention, "ATTN_BWD_IMPL", "pallas")
    monkeypatch.setattr(jax_train, "train_augment", lambda key, x: x)
    _, out = ranks
    jcfg = tiny_cfg(disable_lora=True)
    params = jax.tree.map(jnp.asarray, tiny_tree())
    batch = jax.tree.map(jnp.asarray, _batches()[step])
    capture = jax_train.make_train_step_accum(jcfg, _capture_grads(), K, donate=False)
    _, jgrads, jloss = capture(params, _capture_grads().init(params), batch,
                               jax.random.PRNGKey(0))
    got = out[0]["accum_step"]["accum"][step]
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=STEP_LOSS_RTOL)
    jflat = _flat(jgrads)
    want = {n: jflat[n] for n in got["grads"]}
    _hold(got["grads"], want, f"step {step}", rel=STEP_GRAD_REL_TOL, cos_min=STEP_GRAD_COS_MIN)
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in got["grads"].values()))
    jnorm = np.sqrt(sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want.values()))
    assert abs(norm / jnorm - 1) <= 1e-3, (norm, jnorm)


def test_the_accum_step_updates_every_rank_alike(ranks):
    """`make_train_step_accum(mesh=)` is the gradient cache's step across
    ranks, and its update leaves the ranks' params bit-identical."""
    _, out = ranks
    assert out[0]["accum_step"]["step_qualname"].startswith("make_train_step_accum")
    for n, p in out[0]["accum_step"]["params_after"].items():
        assert torch.equal(p, out[1]["accum_step"]["params_after"][n]), n


def test_trainer_takes_accum_across_ranks_and_resumes(ranks):
    """`Trainer(mesh=)` at W=2 with accum_steps=2 runs the gradient cache's
    step, both ranks see the same finite losses, and `resume_multihost`
    gives every rank rank 0's last/ at its step."""
    tmp, out = ranks
    main, other = out[0]["accum_trainer"], out[1]["accum_trainer"]
    assert main["qualname"].startswith("make_train_step_accum")
    assert main["losses"] == other["losses"] and np.isfinite(main["losses"]).all()
    with np.load(tmp / "accum0" / "last" / "params.npz") as f:
        saved = {k.replace("/", "."): f[k] for k in f.files}
    for o in (main, other):
        assert o["resume_step"] == 2
        for n, p in o["params"].items():
            assert np.array_equal(p.numpy(), saved[n]), n


@pytest.mark.parametrize("step_impl", ["global", "shard_map"])
def test_trainer_refuses_accum_only_under_shard_map(tmp_path, step_impl):
    cfg = port_tiny_cfg(disable_lora=True, batch_size=4, epochs=1, accum_steps=2,
                        step_impl=step_impl)
    gcfg = GlobalConfig()
    gcfg.model_config = cfg
    split = SyntheticSplit("train", 8, cfg, seed=0, batch_size=4, drop_last=True)
    if step_impl == "shard_map":
        with pytest.raises(ValueError, match="accum_steps>1 requires step_impl=global"):
            port_train.Trainer(gcfg, None, str(tmp_path), train_loader=split, device="cpu")
        return
    trainer = port_train.Trainer(gcfg, None, str(tmp_path), train_loader=split, device="cpu")
    assert trainer.step_fn.__qualname__.startswith("make_train_step_accum")
