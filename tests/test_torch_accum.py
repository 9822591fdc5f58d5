"""The port's gradient-cache accumulation (`engine/train.py::
make_train_step_accum`, `make_accum_grad_fn`) on the CPU with the tiny
tri-modal model in fp32: against the port's monolithic step at k = 2 and 4,
against the JAX package's `make_train_step_accum`, pass 3's features
against pass 1's under the real augmentation, and the `Trainer` wiring.
Every input comes from a generator seeded here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.engine import schedules as jax_schedules
from clibd_tpu.engine import train as jax_train
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.ops.pallas import attention as jax_attention
from clibd_tpu_torch.config import schema as port_schema
from clibd_tpu_torch.data import SyntheticSplit
from clibd_tpu_torch.engine import schedules as port_schedules
from clibd_tpu_torch.engine import train as port_train
from clibd_tpu_torch.models import model_from_jax
from tests.torch_tiny import port_tiny_cfg, tiny_cfg, tiny_tree, to_torch

# the JAX package's own bound for its accumulation step against its
# monolithic one (tests/test_train.py), on the loss and on the parameters
# after one AdamW update: fp32 sums in another order
LOSS_ATOL = 1e-6
STEP_ATOL, STEP_RTOL = 1e-6, 1e-5
# the gradients themselves: sums over microbatches round otherwise than one
# sum over the batch, and entries whose true value cancels to ~0 (the key
# bias's) keep that noise whole; up to 4.3e-6 on this model, where running
# the monolithic step on the same rows in another order moves a tensor by up
# to 4.8e-4 of its largest entry
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5
GRAD_COS_MIN = 0.99999
# params after one AdamW update, the port against the JAX package
PARAM_ATOL = 1e-5


def _batch(seed, B=8):
    rng = np.random.default_rng(seed)
    att = (rng.random((B, 20)) > 0.3).astype(np.int32)
    att[:, 0] = 1
    ids = rng.integers(1, 300, (B, 20)).astype(np.int32) * att
    return {"image": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "dna": rng.integers(0, 1027, (B, 17)).astype(np.int32),
            "language": {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                         "attention_mask": att},
            "label": rng.integers(0, 5, B)}


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _hold_grads(got, want):
    assert set(got) == set(want)
    for n in want:
        torch.testing.assert_close(got[n], want[n], atol=GRAD_ATOL, rtol=GRAD_RTOL, msg=n)
        if want[n].abs().max() > 0:
            cos = float((got[n] * want[n]).sum() / (got[n].norm() * want[n].norm()))
            assert cos >= GRAD_COS_MIN, (n, cos)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the tiny model's ops gain
    nothing from more, and the suite's workers would oversubscribe the
    cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("remat", [False, "attn"])
@pytest.mark.parametrize("k", [2, 4])
def test_accum_equals_the_monolithic_step(monkeypatch, k, remat):
    """Loss and every gradient of the k-microbatch gradient cache equal the
    monolithic step's, and so do the parameters after one AdamW update
    (augmentation stubbed: the accumulation draws per microbatch, a
    deliberate stream difference)."""
    monkeypatch.setattr(port_train, "train_augment", lambda gen, x: x)
    cfg = port_tiny_cfg(disable_lora=True, remat=bool(remat),
                        remat_policy=remat if remat else "")
    batch = to_torch(_batch(3))
    runs = []
    for accum in (1, k):
        model = model_from_jax(tiny_tree(), cfg, "cpu")
        opt = port_train.build_optimizer(cfg, model,
                                         port_schedules.build_schedule(cfg.optim, 10, 8))
        grad_fn = (port_train.make_accum_grad_fn(cfg, model, accum) if accum > 1 else
                   lambda b, g: port_train.make_loss_fn(cfg, model)(b, g).backward())
        loss = port_train.make_loss_fn(cfg, model)(batch, None).detach()
        if accum > 1:
            loss = grad_fn(batch, None)
        else:
            grad_fn(batch, None)
        grads = _grads(model)
        opt.step()
        runs.append((loss, grads, {n: p.detach().clone() for n, p in model.named_parameters()}))
    (want_loss, want, want_p), (got_loss, got, got_p) = runs
    assert abs(float(got_loss) - float(want_loss)) <= LOSS_ATOL
    assert "logit_scale" in got
    _hold_grads(got, want)
    for n in want_p:
        torch.testing.assert_close(got_p[n], want_p[n], atol=STEP_ATOL, rtol=STEP_RTOL, msg=n)


def test_frozen_tower_and_fixed_temperature(monkeypatch):
    """A frozen tower's features carry no graph and a fixed temperature
    has no gradient: the gradient cache still equals the monolithic step."""
    monkeypatch.setattr(port_train, "train_augment", lambda gen, x: x)
    cfg = port_tiny_cfg(disable_lora=True)
    cfg.image.freeze = True
    cfg.loss.fix_temperature = True
    model = model_from_jax(tiny_tree(), cfg, "cpu")
    batch = to_torch(_batch(4))
    port_train.make_loss_fn(cfg, model)(batch, None).backward()
    want = _grads(model)
    model.zero_grad(set_to_none=True)
    port_train.make_accum_grad_fn(cfg, model, 2)(batch, None)
    got = _grads(model)
    assert not any(n.startswith("image_encoder") for n in got) and "logit_scale" not in got
    _hold_grads(got, want)


def test_accum_step_matches_jax(monkeypatch):
    """One accumulation step (k=2) in each package from the same weights and
    batch, through each package's optimizer with its global-norm clip on the
    summed gradients: the parameters agree after the update (augmentation
    stubbed on both sides; JAX's attention through its
    Pallas kernels in interpret mode, which round P to bf16 as the port's
    plain versions do)."""
    monkeypatch.setattr(jax_layers, "ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(jax_attention, "ATTN_BWD_IMPL", "pallas")
    monkeypatch.setattr(jax_train, "train_augment", lambda key, x: x)
    monkeypatch.setattr(port_train, "train_augment", lambda gen, x: x)
    jcfg, pcfg = tiny_cfg(disable_lora=True), port_tiny_cfg(disable_lora=True)
    for cfg in (jcfg, pcfg):
        cfg.optim.grad_clip_norm = 0.05
        cfg.optim.lr_config.max_lr = 1e-3
    tree = tiny_tree()
    batch = _batch(5)
    jsched = jax_schedules.build_schedule(jcfg.optim, 10, 8)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jax_train.build_optimizer(jcfg, jparams, jsched)
    jstep = jax_train.make_train_step_accum(jcfg, jopt, 2, donate=False)
    jparams, _, jloss = jstep(jparams, jopt.init(jparams), jax.tree.map(jnp.asarray, batch),
                              jax.random.PRNGKey(0))
    jflat = {".".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jparams)}

    model = model_from_jax(tree, pcfg, "cpu")
    popt = port_train.build_optimizer(pcfg, model,
                                      port_schedules.build_schedule(pcfg.optim, 10, 8))
    loss = port_train.make_train_step_accum(pcfg, model, popt, 2)(to_torch(batch), None)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


def test_pass_three_sees_pass_one_features(monkeypatch):
    """With the real augmentation, each microbatch's features in pass 3 are
    pass 1's bit for bit: the same generator is made again per microbatch."""
    cfg = port_tiny_cfg(disable_lora=True)
    model = model_from_jax(tiny_tree(), cfg, "cpu")
    seen = []
    apply = port_train.clibd_apply

    def recorded(*args, **kwargs):
        out = apply(*args, **kwargs)
        seen.append({m: out[m].detach().clone() for m in ("image", "dna", "language")})
        return out

    monkeypatch.setattr(port_train, "clibd_apply", recorded)
    gen = port_train.batch_generator(torch.device("cpu"), 42, 1, 3)
    port_train.make_accum_grad_fn(cfg, model, 4)(to_torch(_batch(6)), gen)
    assert len(seen) == 8
    for first, again in zip(seen[:4], seen[4:]):
        for m in first:
            assert torch.equal(first[m], again[m]), m
    # the microbatches draw different augmentations
    assert not torch.equal(seen[0]["image"], seen[1]["image"])
    a = port_train.fold_in(gen, 2)
    b = port_train.fold_in(port_train.batch_generator(torch.device("cpu"), 42, 1, 3), 2)
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    assert port_train.fold_in(None, 0) is None


def test_a_batch_that_k_does_not_divide_raises():
    cfg = port_tiny_cfg(disable_lora=True)
    model = model_from_jax(tiny_tree(), cfg, "cpu")
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        port_train.make_accum_grad_fn(cfg, model, 3)(to_torch(_batch(7)), None)


def test_trainer_runs_the_accumulation_step(tmp_path):
    """`accum_steps: 2` in the config: the Trainer's step is the gradient
    cache, and an epoch with an eval runs and writes its checkpoints."""
    gcfg = port_schema.GlobalConfig()
    gcfg.model_config = port_tiny_cfg(batch_size=4, epochs=1, disable_lora=True, accum_steps=2)
    splits = {n: SyntheticSplit(n, r, gcfg.model_config, seed=i) for i, (n, r) in
              enumerate({"train": 8, "all_keys": 8, "val_seen": 4, "val_unseen": 4}.items())}
    trainer = port_train.Trainer(gcfg, None, str(tmp_path / "out"), train_loader=splits["train"],
                                 eval_loader_factory=lambda split, train: splits[split],
                                 device="cpu")
    assert trainer.step_fn.__qualname__.startswith("make_train_step_accum")
    history = trainer.fit()
    trainer.close()
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"][0])
    assert trainer.optimizer.update_count() == 2
    assert (tmp_path / "out" / "last" / "opt_state.npz").exists()
