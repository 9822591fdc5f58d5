"""The port's multi-rank training, extraction and SimCLR on two gloo ranks on
the CPU (`tests/torch_ranks.py`, started once for the file), with the tiny
tri-modal model of `tests/torch_tiny.py` in fp32 from one JAX weight set:

- two updates of `make_train_step_shard_map`'s gradients (augmentation the
  identity on both sides, as tests/test_train.py's shard_map test does it)
  against `clibd_tpu`'s `make_train_step_shard_map` on a 2-device mesh (its
  Pallas attention in interpret mode) and its AdamW, and against the port's
  own global step on the whole batch: the same losses and updates, and
  gradients that are the global batch's, neither W times nor 1/W times it;
- `Trainer.fit` at W=2: only rank 0 writes checkpoints, every rank sees the
  same losses and eval; `resume_multihost` gives every rank rank 0's
  checkpoint, whatever stale copy a rank holds at the same path;
- `extract_split_multihost` over an odd 25 rows against `extract_split`;
- the data-parallel SimCLR step against `clibd_tpu`'s
  `make_simclr_step(mesh=)` on 2 devices (augmentation the identity).

Every input is drawn here from a seeded generator.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.engine import simclr as jax_simclr
from clibd_tpu.engine import train as jax_train
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.models.vit import init_vit_params
from clibd_tpu.ops.pallas import attention as jax_attention
from clibd_tpu.parallel.mesh import create_mesh as jax_create_mesh
from clibd_tpu_torch.data import SyntheticSplit
from clibd_tpu_torch.engine import train as port_train
from clibd_tpu_torch.engine.extract import extract_split
from clibd_tpu_torch.models import model_from_jax
from clibd_tpu_torch.models.convert import params_from_jax
from tests.test_torch_train_step import (ADAM_ATOL, STEP_GRAD_COS_MIN, STEP_GRAD_REL_TOL,
                                         STEP_LOSS_RTOL, _capture_grads)
from tests.torch_ranks import run_ranks
from tests.torch_tiny import port_tiny_cfg, tiny_batch, tiny_cfg, tiny_tree, to_torch

W = 2
LR = 5e-5  # the flagship's peak LR (one_cycle max_lr)
EMBED_ATOL = 1e-5        # a row encoded in a batch of other rows
SIMCLR = {"lr": 1e-6, "weight_decay": 1e-4, "temperature": 0.1, "output_dim": 64}
PARAM_ATOL = 1e-5        # tests/test_torch_simclr.py's


def _batches():
    return [tiny_batch(seed=s, B=4) for s in (1, 2)]


def _simclr_payload():
    cfg = port_tiny_cfg(disable_lora=True)
    cfg.dna.enable = cfg.language.enable = False
    tree = jax.tree.map(np.asarray, init_vit_params(jax.random.PRNGKey(4), tiny_cfg().image.vit,
                                                     output_dim=SIMCLR["output_dim"],
                                                     lora_rank=0))
    rng = np.random.default_rng(11)
    v1, v2 = (rng.random((2 * W, 32, 32, 3), dtype=np.float32) for _ in range(2))
    return tree, {**SIMCLR, "cfg": cfg, "state": params_from_jax(tree), "v1": v1, "v2": v2}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pcfg = port_tiny_cfg(disable_lora=True)
    trainer_cfg = port_tiny_cfg(disable_lora=True, batch_size=2, epochs=1,
                                checkpoint_every_steps=1)
    _, simclr = _simclr_payload()
    data = {"cfg": pcfg, "state": model_from_jax(tiny_tree(), pcfg, "cpu").state_dict(),
            "lr": LR, "batches": _batches(), "trainer_cfg": trainer_cfg,
            "trainer_rows": {"train": 8, "all_keys": 9, "val_seen": 5, "val_unseen": 5},
            "extract_rows": 25, "extract_batch": 4, "simclr": simclr}
    tmp = tmp_path_factory.mktemp("multirank")
    out = run_ranks(W, ["train_step", "trainer", "extract", "simclr_step"], data, tmp)
    return tmp, data, out


def _flat(tree) -> dict:
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads(got: dict, want: dict, what: str):
    for n, g in got.items():
        g = g.numpy().ravel().astype(np.float64)
        w = want[n].ravel().astype(np.float64)
        assert np.abs(g - w).max() <= STEP_GRAD_REL_TOL * np.abs(w).max() + 1e-9, (what, n)
        if np.abs(w).max() > 0:
            assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= STEP_GRAD_COS_MIN, (what, n)


def _assert_ranks_agree(out):
    """Every rank's losses, averaged gradients and params are rank 0's, bit
    for bit (so the other tests hold rank 0's alone)."""
    main = out[0]["train_step"]
    for o in out[1:]:
        got = o["train_step"]
        assert [float(x) for x in got["losses"]] == [float(x) for x in main["losses"]]
        for key in ("grads", "params"):
            for mine, theirs in zip(got[key], main[key]):
                assert set(mine) == set(theirs)
                for n, v in mine.items():
                    assert torch.equal(v, theirs[n]), (key, n)


def _jax_tree(like, flat: dict):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jnp.asarray(flat[".".join(str(k.key) for k in path)].numpy())
         for path, _ in jax.tree_util.tree_leaves_with_path(like)])


def test_train_step_matches_jax_shard_map(ranks, monkeypatch):
    """Each step from the params a rank held before it: the loss and the
    averaged gradients against clibd_tpu's shard_map step on 2 CPU devices
    from the same params; then JAX's AdamW (`build_optimizer`) fed the
    rank's gradients gives the rank's params after each update.

    JAX's step psums gradients that its gather has already summed, so its
    gradient is W times the global batch's (ROADMAP.md Queue 3; AdamW's
    update hides the scale but for eps): the port's are held against W^-1
    times JAX's.  The updates are compared from the same gradients because
    AdamW normalises each element: where an element's gradient is within
    float noise of zero, the two libraries' noise would move it by up to
    2 * lr apart."""
    _, data, out = ranks
    monkeypatch.setattr(jax_layers, "ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(jax_attention, "ATTN_BWD_IMPL", "pallas")
    monkeypatch.setattr(jax_train, "train_augment", lambda key, x: x)
    jcfg = tiny_cfg(disable_lora=True)
    like = jax.tree.map(jnp.asarray, tiny_tree())
    capture = jax_train.make_train_step_shard_map(jcfg, _capture_grads(),
                                                  jax_create_mesh(jax.devices()[:W]),
                                                  donate=False)
    opt = jax_train.build_optimizer(jcfg, like, lambda i: LR)
    _assert_ranks_agree(out)
    got = out[0]["train_step"]
    state = opt.init(like)
    for i, batch in enumerate(_batches()):
        params = _jax_tree(like, got["params"][i])
        _, jgrads, jloss = capture(params, _capture_grads().init(params),
                                   jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(i))
        np.testing.assert_allclose(float(got["losses"][i]), float(jloss), rtol=STEP_LOSS_RTOL)
        _assert_grads(got["grads"][i], {n: g / W for n, g in _flat(jgrads).items()},
                      f"step {i}")
        grads = _jax_tree(like, {n: got["grads"][i].get(n, torch.zeros(v.shape))
                                 for n, v in _flat(like).items()})
        updates, state = opt.update(grads, state, params)
        after = _flat(optax.apply_updates(params, updates))
        for n, p in got["params"][i + 1].items():
            np.testing.assert_allclose(p.numpy(), after[n], rtol=0, atol=ADAM_ATOL,
                                       err_msg=f"step {i} {n}")


def test_train_step_equals_the_global_batch_step(ranks, monkeypatch):
    """The port's W=2 step against its own W=1 step on the whole batch, at
    the bounds it is held to against JAX, from the params the ranks held
    before each step: the same loss, and gradients that are the global
    batch's (the encoders' and logit_scale's, neither W times nor 1/W
    times)."""
    _, data, out = ranks
    monkeypatch.setattr(port_train, "train_augment", lambda gen, x: x)
    cfg = port_tiny_cfg(disable_lora=True)
    model = model_from_jax(tiny_tree(), cfg, "cpu")
    loss_fn = port_train.make_loss_fn(cfg, model)
    _assert_ranks_agree(out)
    got = out[0]["train_step"]
    for i, batch in enumerate(_batches()):
        model.load_state_dict(got["params"][i])
        model.zero_grad(set_to_none=True)
        loss = loss_fn(to_torch(batch), None)
        loss.backward()
        grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
        assert "logit_scale" in grads and set(got["grads"][i]) == set(grads)
        np.testing.assert_allclose(float(got["losses"][i]), float(loss.detach()),
                                   rtol=STEP_LOSS_RTOL)
        _assert_grads(got["grads"][i], grads, f"step {i}")


def test_trainer_writes_checkpoints_on_rank_0_only(ranks):
    tmp, _, out = ranks
    main, other = out[0]["trainer"], out[1]["trainer"]
    assert main["world_size"] == other["world_size"] == W
    for sub in ("last", "best"):
        for f in ("params.npz", "opt_state.npz", "meta.json"):
            assert f"{sub}/{f}" in main["written"], main["written"]
    assert other["written"] == []
    assert main["history"]["loss"] == other["history"]["loss"]
    assert len(main["history"]["loss"]) == 1 and np.isfinite(main["history"]["loss"][0])
    assert main["history"]["overall_acc"] == other["history"]["overall_acc"]
    assert len(main["history"]["overall_acc"]) == 1


def test_resume_multihost_ignores_a_stale_local_copy(ranks):
    """Rank 1's own last/ (another run's, step 99) is never read: both ranks
    hold rank 0's params, optimizer state and step, bit for bit, and a path
    rank 0 lacks is a fresh start everywhere."""
    tmp, _, out = ranks
    main, other = out[0]["trainer"], out[1]["trainer"]
    with np.load(tmp / "out0" / "last" / "params.npz") as f:
        saved = {k.replace("/", "."): f[k] for k in f.files}
    for o in (main, other):
        assert o["resume_step"] == 2 and o["update_count"] == 2 and o["resume_epoch"] == 1
        assert o["none_epoch"] is None
        assert set(o["params"]) == set(saved)
        for n, p in o["params"].items():
            assert np.array_equal(p.numpy(), saved[n]), n
    assert set(main["opt_state"]) == set(other["opt_state"]) and main["opt_state"]
    for n, state in main["opt_state"].items():
        for k, v in state.items():
            assert torch.equal(v, other["opt_state"][n][k]), (n, k)


def test_extract_split_multihost_equals_one_process(ranks):
    """25 rows over 2 ranks (13 and 12, the second wrap-padded to 13): every
    rank's dict is the single process's, row for row, labels and ids
    identical."""
    _, data, out = ranks
    cfg = data["cfg"]
    model = model_from_jax(tiny_tree(), cfg, "cpu")
    loader = SyntheticSplit("all_keys", 25, cfg, seed=3, batch_size=4)
    want = extract_split(model, cfg, loader, for_key_set=True)
    for r in range(W):
        got = out[r]["extract"]
        assert got["label_list"] == want["label_list"] and got["file_name_list"] == want[
            "file_name_list"]
        for key in ("encoded_image_feature", "encoded_dna_feature", "encoded_language_feature",
                    "averaged_feature", "concatenated_feature", "all_key_features"):
            assert got[key].shape == want[key].shape, key
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=EMBED_ATOL,
                                       err_msg=f"rank {r} {key}")
        assert got["all_key_features_label"] == want["all_key_features_label"]


def test_simclr_step_matches_jax_on_two_devices(ranks, monkeypatch):
    """The loss (pmean of the ranks' NT-Xent over local negatives), the
    gradients (their psum) and the params after one Adam update against
    clibd_tpu's make_simclr_step(mesh=) on 2 CPU devices."""
    _, data, out = ranks
    monkeypatch.setattr(jax_layers, "ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(jax_attention, "ATTN_BWD_IMPL", "pallas")
    monkeypatch.setattr(jax_simclr, "simclr_augment", lambda key, x, size: x)
    tree, payload = _simclr_payload()
    jcfg = tiny_cfg(disable_lora=True)
    jcfg.dna.enable = jcfg.language.enable = False
    mesh = jax_create_mesh(jax.devices()[:W])
    jopt = optax.chain(optax.add_decayed_weights(SIMCLR["weight_decay"]), optax.scale_by_adam(),
                       optax.scale_by_learning_rate(SIMCLR["lr"]))
    params = jax.tree.map(jnp.asarray, tree)
    v1, v2 = jnp.asarray(payload["v1"]), jnp.asarray(payload["v2"])
    step = jax_simclr.make_simclr_step(jcfg, jopt, SIMCLR["temperature"], mesh=mesh)
    new_params, _, jloss = step(params, jopt.init(params), v1, v2, jax.random.PRNGKey(0))
    capture = jax_simclr.make_simclr_step(jcfg, _capture_grads(), SIMCLR["temperature"],
                                          mesh=mesh)
    _, jgrads, _ = capture(params, _capture_grads().init(params), v1, v2,
                           jax.random.PRNGKey(0))
    jg, jp = _flat(jgrads), _flat(new_params)
    for r in range(W):
        got = out[r]["simclr_step"]
        np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=STEP_LOSS_RTOL)
        _assert_grads(got["grads"], jg, f"rank {r}")
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), jp[n], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"rank {r} {n}")
