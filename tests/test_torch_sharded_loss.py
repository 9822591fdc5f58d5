"""`sharded_clip_loss` of the port on W=2 and W=4 gloo ranks on the CPU
(`tests/torch_ranks.py`, started once a world size) against the JAX
package's under `shard_map` on 2 and 4 CPU devices, and against
`clip_loss` on the global batch: both `local_loss` arms, with repeated
labels, with and without the text tower.

Every rank returns the same loss.  The gradient a rank's features get is W
times dL/df of the global loss, in both packages: the all-gather's backward
sums the W ranks' cotangents; the trainer's mean of the parameters'
gradients takes the W out again.  The logit scale's gradients average over
the ranks to dL/ds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from clibd_tpu.config.schema import LossConfig as JaxLossConfig
from clibd_tpu.ops import loss as jax_loss
from clibd_tpu.parallel.mesh import create_mesh as jax_create_mesh
from clibd_tpu_torch.config.schema import LossConfig
from clibd_tpu_torch.ops import loss as port_loss
from tests.torch_ranks import run_ranks

B, D = 3, 16
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5  # of the largest entry of the rank's gradient: fp32 sums in another order
CASES = [(local, mods) for local in (False, True)
         for mods in (("image", "dna", "language"), ("image", "dna"))]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max(),
                               err_msg=what)


def _name(local, mods):
    return f"{'local' if local else 'global'}_{'_'.join(mods)}"


def _cases(world):
    rng = np.random.default_rng(40 + world)
    cases = {}
    for local, mods in CASES:
        cfg = LossConfig()
        cfg.local_loss = local
        cases[_name(local, mods)] = {
            "features": {m: rng.standard_normal((world * B, D)).astype(np.float32) for m in mods},
            "labels": rng.integers(0, world + 1, world * B),  # repeated labels
            "scale": np.float32(rng.uniform(5.0, 20.0)), "cfg": cfg}
    return cases


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    cases = _cases(world)
    out = run_ranks(world, ["sharded_loss"], {"cases": cases},
                    tmp_path_factory.mktemp(f"loss{world}"))
    return world, cases, [o["sharded_loss"] for o in out]


def _jax_per_device(world, case, local):
    """The loss and, per device, the gradients of its features and of the
    logit scale inside shard_map, as the JAX train step takes them."""
    cfg = JaxLossConfig()
    cfg.local_loss = local
    mods = list(case["features"])

    def per_device(feats, labels, scale):
        def f(feats, scale):
            full = {m: feats.get(m) for m in ("image", "dna", "language")}
            return jax_loss.sharded_clip_loss(full, labels, scale, cfg)

        loss, (g_feats, g_scale) = jax.value_and_grad(f, argnums=(0, 1))(feats, scale)
        return loss, g_feats, g_scale[None]

    fn = jax.jit(jax.shard_map(per_device, mesh=jax_create_mesh(jax.devices()[:world]),
                               in_specs=({m: P("data") for m in mods}, P("data"), P()),
                               out_specs=(P(), {m: P("data") for m in mods}, P("data")),
                               check_vma=False))
    loss, g_feats, g_scale = fn({m: jnp.asarray(v) for m, v in case["features"].items()},
                                jnp.asarray(case["labels"]), jnp.float32(case["scale"]))
    return float(loss), {m: np.asarray(v) for m, v in g_feats.items()}, np.asarray(g_scale)


@pytest.mark.parametrize("local,mods", CASES, ids=[_name(*c) for c in CASES])
def test_sharded_loss_matches_jax_shard_map(ranks, local, mods):
    world, cases, out = ranks
    case = cases[_name(local, mods)]
    jloss, jgrads, jscale = _jax_per_device(world, case, local)
    for r in range(world):
        got = out[r][_name(local, mods)]
        np.testing.assert_allclose(float(got["loss"]), jloss, rtol=LOSS_RTOL)
        for m in mods:
            _close(got["grads"][m].numpy(), jgrads[m][r * B:(r + 1) * B], f"{m} rank {r}")
        np.testing.assert_allclose(float(got["scale_grad"]), jscale[r], rtol=GRAD_RTOL)


@pytest.mark.parametrize("local,mods", CASES, ids=[_name(*c) for c in CASES])
def test_sharded_loss_is_clip_loss_of_the_global_batch(ranks, local, mods):
    """Every rank's loss is clip_loss of the global batch; rank r's feature
    gradients are W times its rows of clip_loss's, and the ranks' logit-scale
    gradients average to clip_loss's."""
    world, cases, out = ranks
    case = cases[_name(local, mods)]
    feats = {m: torch.from_numpy(v).requires_grad_() for m, v in case["features"].items()}
    scale = torch.tensor(case["scale"], requires_grad=True)
    loss = port_loss.clip_loss(feats, torch.from_numpy(case["labels"]), scale, case["cfg"])
    grads = dict(zip(feats, torch.autograd.grad(loss, [*feats.values(), scale])))
    scale_grad = torch.autograd.grad(
        port_loss.clip_loss(feats, torch.from_numpy(case["labels"]), scale, case["cfg"]),
        scale)[0]
    ranks_scale = []
    for r in range(world):
        got = out[r][_name(local, mods)]
        np.testing.assert_allclose(float(got["loss"]), float(loss.detach()), rtol=LOSS_RTOL)
        for m in mods:
            _close(got["grads"][m].numpy(), world * grads[m][r * B:(r + 1) * B].numpy(),
                   f"{m} rank {r}")
        ranks_scale.append(float(got["scale_grad"]))
    np.testing.assert_allclose(np.mean(ranks_scale), float(scale_grad), rtol=GRAD_RTOL)
    losses = [float(out[r][_name(local, mods)]["loss"]) for r in range(world)]
    assert len(set(losses)) == 1, losses
