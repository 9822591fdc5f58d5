"""The optimizer state the port checkpoints is optax's (`engine/checkpoint.py`:
`optax_keys`, `opt_state_to_optax`, `opt_state_from_optax`): the key sets
and dtypes of the JAX package's `_flatten_with_paths(optimizer.init(params))`
for `build_optimizer` (grad clip on and off, LoRA on and off, a frozen
tower) and SimCLR's chain; three updates in one package, a checkpoint, a
resume in the other and a fourth update agree; and a checkpoint in the
port's earlier layout still loads.  Every gradient comes from a generator
seeded here.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.engine import checkpoint as jax_checkpoint
from clibd_tpu.engine import schedules as jax_schedules
from clibd_tpu.engine import train as jax_train
from clibd_tpu.models.vit import init_vit_params
from clibd_tpu_torch.engine import checkpoint as port_checkpoint
from clibd_tpu_torch.engine import schedules as port_schedules
from clibd_tpu_torch.engine import train as port_train
from clibd_tpu_torch.models import model_from_jax
from clibd_tpu_torch.models.convert import params_from_jax
from clibd_tpu_torch.models.vit import ViT
from tests.torch_tiny import port_tiny_cfg, tiny_cfg, tiny_tree

# params after the fourth update, one package against the other: the same
# fp32 Adam arithmetic in another order on parameters of magnitude <= ~1
NEXT_UPDATE_ATOL = 1e-6
SIMCLR_LR, SIMCLR_WD, SIMCLR_STEPS_PER_EPOCH = 1e-3, 1e-4, 2

CASES = {  # name → (disable_lora, grad_clip_norm, frozen tower)
    "full": (True, 0.0, None),
    "full_clip": (True, 0.05, None),
    "lora": (False, 0.0, None),
    "lora_clip_frozen_dna": (False, 0.05, "dna"),
    "full_frozen_image": (True, 0.0, "image"),
}


def _simclr_schedule(np_module):
    """SimCLR's per-epoch cosine (`clibd_tpu/engine/simclr.py:158-166`)."""
    def schedule(step):
        k = np_module.maximum(step // SIMCLR_STEPS_PER_EPOCH - 2, 0)
        return SIMCLR_LR * 0.5 * (1.0 + np_module.cos(np_module.pi * k / SIMCLR_STEPS_PER_EPOCH))

    return schedule


def _setup(case):
    """→ (JAX params, JAX optimizer, port model, port optimizer) for a case
    of CASES or "simclr"."""
    if case == "simclr":
        vcfg = tiny_cfg().image.vit
        tree = jax.tree.map(np.asarray, init_vit_params(jax.random.PRNGKey(3), vcfg,
                                                         output_dim=64, lora_rank=0))
        jopt = optax.chain(optax.add_decayed_weights(SIMCLR_WD), optax.scale_by_adam(),
                           optax.scale_by_learning_rate(_simclr_schedule(jnp)))
        model = ViT(port_tiny_cfg().image.vit, output_dim=64)
        model.load_state_dict(params_from_jax(tree))
        schedule = _simclr_schedule(np)
        popt = port_train.ScheduledAdam(model.parameters(), lambda i: float(schedule(i)),
                                        weight_decay=SIMCLR_WD)
        return jax.tree.map(jnp.asarray, tree), jopt, model, popt
    disable_lora, clip, frozen = CASES[case]
    jcfg, pcfg = tiny_cfg(disable_lora=disable_lora), port_tiny_cfg(disable_lora=disable_lora)
    for cfg in (jcfg, pcfg):
        cfg.optim.grad_clip_norm = clip
        cfg.optim.lr_config.max_lr = 1e-3
        if frozen:
            getattr(cfg, frozen).freeze = True
    tree = tiny_tree(disable_lora)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jax_train.build_optimizer(jcfg, jparams,
                                     jax_schedules.build_schedule(jcfg.optim, 10, 8))
    model = model_from_jax(tree, pcfg, "cpu")
    popt = port_train.build_optimizer(pcfg, model, port_schedules.build_schedule(pcfg.optim, 10, 8))
    return jparams, jopt, model, popt


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _gradients(model, seed):
    rng = np.random.default_rng(seed)
    return {n: np.asarray(rng.standard_normal(tuple(p.shape)) * 1e-2, np.float32)
            for n, p in model.named_parameters()}


def _jax_update(jopt, jparams, jstate, grads):
    gtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [jnp.asarray(grads[".".join(str(k.key) for k in path)])
         for path, _ in jax.tree_util.tree_leaves_with_path(jparams)])
    updates, jstate = jopt.update(gtree, jstate, jparams)
    return optax.apply_updates(jparams, updates), jstate


def _port_update(model, popt, grads):
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n]) if p.requires_grad else None
    popt.step()


def _hold(model, jparams):
    want = _flat(jparams)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n.replace(".", "/")], rtol=0,
                                   atol=NEXT_UPDATE_ATOL, err_msg=n)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the tiny model's ops gain
    nothing from more, and the suite's workers would oversubscribe the
    cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("case", [*CASES, "simclr"])
def test_keys_and_dtypes_equal_optax(case):
    jparams, jopt, model, popt = _setup(case)
    want = jax_checkpoint._flatten_with_paths(jopt.init(jparams))
    got = port_checkpoint.opt_state_to_optax(model, popt)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)  # zeros and count 0
    counts = [k for k in want if k.endswith("count")]
    assert len(counts) == 2 and all(want[k].dtype == np.int32 for k in counts)


@pytest.mark.parametrize("case", [*CASES, "simclr"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, case):
    """Three updates in JAX, its checkpoint, the port's resume (params and
    optimizer state), a fourth update in both: the params agree."""
    jparams, jopt, model, popt = _setup(case)
    jstate = jopt.init(jparams)
    for i in range(3):
        jparams, jstate = _jax_update(jopt, jparams, jstate, _gradients(model, 10 + i))
    jax_checkpoint.save_train_state(str(tmp_path / "last"), jparams, jstate, step=3, epoch=0)
    for p in model.parameters():  # the resume must restore every value
        torch.nn.init.zeros_(p.data)
    meta = port_checkpoint.load_train_state(str(tmp_path / "last"), model, popt)
    assert meta["step"] == 3 and popt.update_count() == 3
    grads = _gradients(model, 13)
    jparams, _ = _jax_update(jopt, jparams, jstate, grads)
    _port_update(model, popt, grads)
    _hold(model, jparams)


@pytest.mark.parametrize("case", [*CASES, "simclr"])
def test_port_checkpoint_resumes_in_jax(tmp_path, case):
    """Three updates in the port, its checkpoint, the JAX package's resume
    (`load_train_state` against a fresh optax state, as `Trainer.resume`
    does), a fourth update in both: the params agree."""
    jparams, jopt, model, popt = _setup(case)
    for i in range(3):
        _port_update(model, popt, _gradients(model, 20 + i))
    port_checkpoint.save_train_state(str(tmp_path / "last"), model, popt, step=3, epoch=0)
    params, jstate, meta = jax_checkpoint.load_train_state(str(tmp_path / "last"),
                                                           opt_state_like=jopt.init(jparams))
    assert jstate is not None and meta["step"] == 3
    jparams = jax.tree.map(jnp.asarray, params)
    grads = _gradients(model, 23)
    jparams, _ = _jax_update(jopt, jparams, jstate, grads)
    _port_update(model, popt, grads)
    _hold(model, jparams)


def test_earlier_layout_still_loads(tmp_path):
    """An opt_state.npz in the port's earlier layout ("<key>/exp_avg",
    "<key>/exp_avg_sq", "<key>/step") loads into the same Adam state."""
    _, _, model, popt = _setup("lora_clip_frozen_dna")
    for i in range(2):
        _port_update(model, popt, _gradients(model, 30 + i))
    port_checkpoint.save_train_state(str(tmp_path / "ck"), model, popt, step=2, epoch=0)
    earlier = {}
    for n, p in model.named_parameters():
        if p.requires_grad:
            for field in ("exp_avg", "exp_avg_sq", "step"):
                earlier[f"{n.replace('.', '/')}/{field}"] = \
                    popt.state[p][field].float().numpy()
    np.savez(tmp_path / "ck" / "opt_state.npz", **earlier)
    _, _, fresh, fresh_opt = _setup("lora_clip_frozen_dna")
    port_checkpoint.load_train_state(str(tmp_path / "ck"), fresh, fresh_opt)
    assert fresh_opt.update_count() == 2
    for (n, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), n
        if p.requires_grad:
            for field in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(popt.state[p][field], fresh_opt.state[q][field]), n


def test_a_foreign_key_set_raises(tmp_path):
    _, _, model, popt = _setup("full")
    flat = port_checkpoint.opt_state_to_optax(model, popt)
    flat.pop(next(k for k in flat if "/mu/" in k))
    with pytest.raises(ValueError, match="do not match"):
        port_checkpoint.opt_state_from_optax(flat, model, popt)
