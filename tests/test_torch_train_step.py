"""One train step of the port against clibd_tpu, on the CPU, with a tiny
tri-modal model (2 layers, narrow widths) in fp32: remat policies, the
trainable set, the loss and gradients of a step (JAX's attention through
its Pallas kernels in interpret mode, forward and backward) and the AdamW
updates against the optax chain.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.engine import schedules as jax_schedules
from clibd_tpu.engine import train as jax_train
from clibd_tpu.models import clibd as jax_clibd
from clibd_tpu.models import init_clibd_params
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.ops.pallas import attention as jax_attention
from clibd_tpu_torch.engine import schedules as port_schedules
from clibd_tpu_torch.engine import train as port_train
from clibd_tpu_torch.models import clibd_apply, model_from_jax, set_trainable
from clibd_tpu_torch.models.clibd import CLIBD
from clibd_tpu_torch.ops import attention as port_attention
from clibd_tpu_torch.ops import loss as port_loss
from tests.torch_tiny import port_tiny_cfg, tiny_batch, tiny_cfg, tiny_tree, to_torch

# the tiny model's loss and gradients in fp32: both packages round P (and, in
# the backward, dS) to bf16 after fp32 maths, so an entry within float noise
# of a bf16 boundary may round the other way, by one bf16 ulp (2^-8 of it).
# Most gradient entries agree to ~1e-7; with 5 image tokens one flip moves a
# small tensor such as cls_token by up to ~1% of its largest entry, and
# leaves the direction of every tensor unchanged to 1e-4
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_REL_TOL = 2e-2
STEP_GRAD_COS_MIN = 0.9999
# three AdamW updates from identical gradients, fp32 parameters of magnitude
# <= ~1: float32 rounding of the same arithmetic in another order
ADAM_ATOL = 1e-6


def _port_loss_and_grads(model, cfg, remat):
    x = to_torch(tiny_batch())
    out = clibd_apply(model, cfg, x["image"], x["dna"], x["language"],
                      compute_dtype=torch.float32, remat=remat)
    loss = port_loss.clip_loss(out, x["label"], out["logit_scale"], cfg.loss)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return loss, dict(zip([n for n, _ in named],
                          torch.autograd.grad(loss, [p for _, p in named])))


@pytest.mark.parametrize("remat", [True, "attn", "qkv", "mlp", "attn+mlp", "dots"])
def test_remat_policies_leave_loss_and_gradients_unchanged(remat):
    cfg = port_tiny_cfg(disable_lora=True)
    model = model_from_jax(tiny_tree(), cfg, "cpu")
    loss0, g0 = _port_loss_and_grads(model, cfg, False)
    loss, g = _port_loss_and_grads(model, cfg, remat)
    assert torch.equal(loss, loss0)
    for n in g0:
        assert torch.equal(g[n], g0[n]), n


@pytest.mark.parametrize("remat,per_layer", [(False, 1), ("attn", 1), ("attn+qkv", 1),
                                             ("qkv", 2), (True, 2)])
def test_attention_forward_runs_per_layer(monkeypatch, remat, per_layer):
    """Under a policy that saves "attn" the backward does not run the
    attention forward again; blanket remat and policies without it do."""
    cfg = port_tiny_cfg(disable_lora=True)
    model = model_from_jax(tiny_tree(), cfg, "cpu")
    calls = []
    plain = port_attention.flash_attention_qkv_reference

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(port_attention, "flash_attention_qkv_reference", counted)
    _port_loss_and_grads(model, cfg, remat)
    assert len(calls) == 6 * per_layer  # 2 layers x 3 encoders


def test_unknown_remat_policy_raises():
    from clibd_tpu_torch.models.layers import remat_policy

    with pytest.raises(ValueError, match="unknown remat policy"):
        remat_policy("attn+ffn")
    cfg = port_tiny_cfg(disable_lora=True)
    model = model_from_jax(tiny_tree(), cfg, "cpu")
    with pytest.raises(ValueError, match="unknown remat policy"):
        _port_loss_and_grads(model, cfg, "everything")


def _jax_trainable(cfg):
    tree = init_clibd_params(jax.random.PRNGKey(0), cfg)
    mask = jax_clibd.trainable_mask(tree, cfg)
    flat = jax.tree_util.tree_leaves_with_path(mask)
    return {".".join(str(p.key) for p in path) for path, v in flat if v}


@pytest.mark.parametrize("disable_lora", [True, False])
@pytest.mark.parametrize("fix_temperature", [False, True])
@pytest.mark.parametrize("freeze", [None, "image", "dna", "language"])
def test_trainable_set_matches_jax(disable_lora, fix_temperature, freeze):
    cfgs = [tiny_cfg(disable_lora=disable_lora), port_tiny_cfg(disable_lora=disable_lora)]
    for cfg in cfgs:
        cfg.loss.fix_temperature = fix_temperature
        if freeze:
            getattr(cfg, freeze).freeze = True
    want = _jax_trainable(cfgs[0])
    model = set_trainable(CLIBD(cfgs[1]), cfgs[1])
    got = {n for n, p in model.named_parameters() if p.requires_grad}
    assert got == want
    if not disable_lora:
        assert any(".lora." in n for n in got) and "image_encoder.blocks.qkv_w" not in got


def _capture_grads():
    """An optax transformation whose state is the last gradient: the JAX
    train step then hands back its own loss_fn's gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


@pytest.mark.parametrize("disable_lora", [True, False])
def test_train_step_loss_and_gradients_match_jax(monkeypatch, disable_lora):
    """One train step of the tiny tri-modal model in fp32, the augmentation
    replaced by the identity on both sides, the JAX attention through its
    Pallas kernels (interpret mode) forward and backward."""
    jcfg, pcfg = tiny_cfg(disable_lora=disable_lora), port_tiny_cfg(disable_lora=disable_lora)
    tree = tiny_tree(disable_lora)
    monkeypatch.setattr(jax_layers, "ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(jax_attention, "ATTN_BWD_IMPL", "pallas")
    monkeypatch.setattr(jax_train, "train_augment", lambda key, x: x)
    monkeypatch.setattr(port_train, "train_augment", lambda gen, x: x)
    batch = tiny_batch()
    step = jax_train.make_train_step(jcfg, _capture_grads(), donate=False)
    jparams = jax.tree.map(jnp.asarray, tree)
    _, jgrads, jloss = step(jparams, _capture_grads().init(jparams),
                            jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    jflat = {".".join(str(p.key) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}

    model = model_from_jax(tree, pcfg, "cpu")
    loss = port_train.make_loss_fn(pcfg, model)(to_torch(batch), None)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_RTOL)
    for (n, _), g in zip(named, grads):
        got, want = g.numpy().ravel().astype(np.float64), jflat[n].ravel().astype(np.float64)
        err = float(np.abs(got - want).max())
        assert err <= STEP_GRAD_REL_TOL * float(np.abs(want).max()) + 1e-9, (n, err)
        if np.abs(want).max() > 0:
            cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
            assert cos >= STEP_GRAD_COS_MIN, (n, cos)


@pytest.mark.parametrize("clip", [0.0, 0.05])
@pytest.mark.parametrize("disable_lora", [True, False])
def test_three_adamw_updates_match_optax(clip, disable_lora):
    """The same three gradients through the JAX package's masked optax chain
    and the port's ScheduledAdamW: frozen parameters stay put, and every
    trainable parameter agrees after each update."""
    jcfg, pcfg = tiny_cfg(disable_lora=disable_lora), port_tiny_cfg(disable_lora=disable_lora)
    for cfg in (jcfg, pcfg):
        cfg.optim.grad_clip_norm = clip
        cfg.optim.lr_config.max_lr = 1e-3
    jsched = jax_schedules.build_schedule(jcfg.optim, 10, jcfg.batch_size)
    psched = port_schedules.build_schedule(pcfg.optim, 10, pcfg.batch_size)
    tree = tiny_tree(disable_lora)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jax_train.build_optimizer(jcfg, jparams, jsched)
    jstate = jopt.init(jparams)
    model = model_from_jax(tree, pcfg, "cpu")
    popt = port_train.build_optimizer(pcfg, model, psched)
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = {n: np.asarray(rng.standard_normal(p.shape) * 1e-2, np.float32)
                 for n, p in model.named_parameters()}
        gtree = jax.tree.map(jnp.asarray, jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams),
            [grads[".".join(str(k.key) for k in path)]
             for path, _ in jax.tree_util.tree_leaves_with_path(jparams)]))
        updates, jstate = jopt.update(gtree, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n]) if p.requires_grad else None
        popt.step()
        jflat = {".".join(str(k.key) for k in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_leaves_with_path(jparams)}
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), jflat[n], rtol=0, atol=ADAM_ATOL,
                                       err_msg=n)
    assert popt.update_count() == 3 and len(names) == len(jflat)
