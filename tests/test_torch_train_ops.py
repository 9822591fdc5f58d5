"""The port's training ops against clibd_tpu, on the CPU: the attention
backward's plain version (against the Pallas kernel in interpret mode and
jax.vjp of the XLA attention), the attention operator's autograd, the loss,
the LR schedules and the augmentations, on the same numpy-seeded inputs.
The CUDA backward kernel is held against its plain version in
`test_torch_kernels.py`, which runs only where there is a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.config.schema import ExperimentConfig, LossConfig
from clibd_tpu.engine import schedules as jax_schedules
from clibd_tpu.ops import augment as jax_augment
from clibd_tpu.ops import loss as jax_loss
from clibd_tpu.ops.pallas import attention as jax_attention
from clibd_tpu_torch.config import schema as port_schema
from clibd_tpu_torch.engine import schedules as port_schedules
from clibd_tpu_torch.ops import attention as port_attention
from clibd_tpu_torch.ops import augment as port_augment
from clibd_tpu_torch.ops import loss as port_loss

NEG = np.finfo(np.float32).min
# backward plain version against the Pallas kernel in interpret mode, per
# part (dq, dk, dv), relative to the part's largest entry: both round P, dS
# and the inputs to bf16 at the same points, so they differ where a value
# within float noise of a bf16 boundary rounds the other way -- one bf16 ulp
# (2^-8) of one entry of a sum
PALLAS_REL_TOL = 4e-3
# against jax.vjp of the XLA attention: autodiff keeps dS and the cotangent
# of P in fp32 where the kernel rounds them to bf16, a few bf16 ulps
XLA_REL_TOL = 2e-2
# fp32 loss and features: float noise of a different summation order
LOSS_RTOL = 1e-5


def _parts_rel(got, want, H):
    D = H * 64
    return [float(np.abs(got[..., i * D:(i + 1) * D] - want[..., i * D:(i + 1) * D]).max()
                  / np.abs(want[..., i * D:(i + 1) * D]).max()) for i in range(3)]


def _attn_inputs(B, N, H, masked, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * 64)).astype(np.float32)
    dout = rng.standard_normal((B, N, H * 64)).astype(np.float32)
    mask = None
    if masked:
        keep = rng.random((B, N)) > 0.3
        keep[:, 0] = True
        if B > 1:
            keep[0] = False  # batch row 0: every key masked
        mask = np.where(keep, 0.0, NEG).astype(np.float32)
    return qkv, dout, mask


@pytest.mark.parametrize("N,H,masked", [(20, 2, True), (33, 2, False), (208, 2, True),
                                         (209, 2, True), (657, 2, False), (657, 2, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_vjp"])
def test_bwd_plain_version_matches_jax(N, H, masked, dtype, ref):
    """N=657 is the overlap-tokenizer DNA tower's length, at one batch row;
    N=208 and 209 the two sides of the CUDA backward's route threshold (the
    whole row on chip up to 208 keys, key-tiled past them)."""
    qkv, dout, mask = _attn_inputs(1 if N > 256 else 3, N, H, masked, seed=N)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm = None if mask is None else jnp.asarray(mask)
    if ref == "pallas_interpret":
        want = jax_attention._flash_bwd_call(jnp.asarray(qkv, jd), jm, jnp.asarray(dout, jd),
                                             num_heads=H, valid_len=N, block_b=1,
                                             has_mask=masked, interpret=True)
    else:
        _, vjp = jax.vjp(lambda t: jax_attention._xla_attention_from_qkv(t, jm, H, N),
                         jnp.asarray(qkv, jd))
        (want,) = vjp(jnp.asarray(dout, jd))
    got = port_attention.flash_attention_qkv_bwd(
        torch.from_numpy(qkv).to(td), torch.from_numpy(dout).to(td), H,
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == td and got.shape == qkv.shape
    rel = _parts_rel(got.float().numpy(), np.asarray(want.astype(jnp.float32)), H)
    assert max(rel) <= (PALLAS_REL_TOL if ref == "pallas_interpret" else XLA_REL_TOL), rel


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_op_on_cpu_runs_the_plain_backward(masked, dtype):
    """On a CPU tensor the operator's gradient is the plain backward's, the
    mask gets none, and no kernel is launched."""
    qkv, dout, mask = _attn_inputs(2, 20, 2, masked, seed=4)
    t = torch.from_numpy(qkv).to(dtype).requires_grad_()
    g = torch.from_numpy(dout).to(dtype)
    m = None if mask is None else torch.from_numpy(mask).requires_grad_()
    launches = (port_attention.flash_attention_qkv.launches,
                port_attention.flash_attention_qkv_bwd.launches)
    out = port_attention.flash_attention_qkv(t, 2, m)
    assert out.requires_grad
    out.backward(g)
    want = port_attention.flash_attention_qkv_bwd_reference(t.detach(), g, 2, m)
    assert torch.equal(t.grad, want)
    assert m is None or m.grad is None
    assert (port_attention.flash_attention_qkv.launches,
            port_attention.flash_attention_qkv_bwd.launches) == launches


def test_fully_masked_row_backward_is_uniform():
    """Batch row 0 has every key masked: P is uniform, so dV of every key is
    the mean of dO over the queries, as in the Pallas kernel."""
    qkv, dout, mask = _attn_inputs(2, 20, 2, True, seed=6)
    got = port_attention.flash_attention_qkv_bwd_reference(
        torch.from_numpy(qkv), torch.from_numpy(dout), 2, torch.from_numpy(mask)).numpy()
    p = np.float32(torch.tensor(1 / 20).to(torch.bfloat16).item())
    do = torch.from_numpy(dout[0]).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got[0, :, 256:], np.broadcast_to(p * do.sum(0), (20, 128)),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("present", [("image", "dna"), ("image", "dna", "language"),
                                     ("dna", "language")])
@pytest.mark.parametrize("bind_to,no_image_text", [(None, False), ("image", False),
                                                   ("dna", False), (None, True)])
def test_clip_loss_and_gradients_match_jax(present, bind_to, no_image_text):
    rng = np.random.default_rng(len(present))
    feats = {m: rng.standard_normal((6, 16)).astype(np.float32) for m in present}
    labels = np.array([0, 1, 0, 2, 1, 3])
    jcfg = LossConfig(bind_to=bind_to, no_image_text_loss=no_image_text)
    pcfg = port_schema.LossConfig(bind_to=bind_to, no_image_text_loss=no_image_text)

    def jloss(f, s):
        return jax_loss.clip_loss(f, jnp.asarray(labels), s, jcfg)

    jv, (jg, jgs) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {m: jnp.asarray(v) for m, v in feats.items()}, jnp.float32(14.28))
    tf = {m: torch.from_numpy(v).requires_grad_() for m, v in feats.items()}
    ts = torch.tensor(14.28, requires_grad=True)
    pv = port_loss.clip_loss(tf, torch.from_numpy(labels), ts, pcfg)
    pv.backward()
    np.testing.assert_allclose(float(pv), float(jv), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(ts.grad), float(jgs), rtol=LOSS_RTOL, atol=1e-7)
    for m in present:
        np.testing.assert_allclose(tf[m].grad.numpy(), np.asarray(jg[m]), rtol=1e-4, atol=1e-6)


def test_clip_loss_needs_two_modalities():
    with pytest.raises(ValueError, match="Too less"):
        port_loss.clip_loss({"image": torch.ones(2, 3)}, torch.arange(2), 1.0,
                            port_schema.LossConfig())


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["one_cycle", "exponential", "step", "cosine", "none"])
@pytest.mark.parametrize("scale", [True, False])
def test_schedule_matches_jax_at_every_step(name, scale):
    total = 37
    jcfg = ExperimentConfig().optim
    pcfg = port_schema.ExperimentConfig().optim
    for c in (jcfg, pcfg):
        c.lr_scheduler = name
        c.scale_lr_by_batch = scale
        c.lr_config.step_size = 5
    j = jax_schedules.build_schedule(jcfg, total, batch_size=128)
    p = port_schedules.build_schedule(pcfg, total, batch_size=128)
    for step in range(total + 3):
        got = p(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(j(step)), rtol=2e-6, err_msg=f"step {step}")
    assert port_schedules.scale_learning_rate(1e-3, 250, world_size=2) == pytest.approx(1e-3)
    with pytest.raises(ValueError, match="Unknown lr_scheduler"):
        pcfg.lr_scheduler = "linear"
        port_schedules.build_schedule(pcfg, total, batch_size=128)


# ---------------------------------------------------------------------------
# augment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 32, 32), (4, 24, 40), (2, 224, 224)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotation_is_bit_identical_to_jax(shape, dtype):
    B, H, W = shape
    rng = np.random.default_rng(H)
    img = rng.random((B, H, W, 3)).astype(np.float32)
    angles = rng.uniform(-45, 45, B).astype(np.float32)
    angles[0], angles[1] = 45.0, -45.0
    want = jax_augment.random_rotate(None, jnp.asarray(img, getattr(jnp, dtype)),
                                     angles=jnp.asarray(angles))
    got = port_augment.random_rotate(None, torch.from_numpy(img).to(getattr(torch, dtype)),
                                     angles=torch.from_numpy(angles))
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_flips_are_bit_identical_to_jax():
    """The port's flips at the decisions jax.random drew for a key."""
    key = jax.random.PRNGKey(3)
    img = np.random.default_rng(0).random((8, 16, 12, 3)).astype(np.float32)
    want = np.asarray(jax_augment.random_flips(key, jnp.asarray(img)))
    kh, kv = jax.random.split(key)
    do_h = np.asarray(jax.random.uniform(kh, (8, 1, 1, 1)) < 0.5).ravel()
    do_v = np.asarray(jax.random.uniform(kv, (8, 1, 1, 1)) < 0.5).ravel()
    assert 0 < do_h.sum() < 8 and 0 < do_v.sum() < 8
    got = port_augment.flip(torch.from_numpy(img), torch.from_numpy(do_h), torch.from_numpy(do_v))
    assert np.array_equal(got.numpy(), want)


def test_train_augment_draws_from_its_generator():
    """Same generator seed → same augmentation; the result only moves
    values (every output value is an input value or the zero fill)."""
    img = torch.rand(4, 32, 32, 3)
    a = port_augment.train_augment(torch.Generator().manual_seed(1), img)
    b = port_augment.train_augment(torch.Generator().manual_seed(1), img)
    c = port_augment.train_augment(torch.Generator().manual_seed(2), img)
    assert torch.equal(a, b) and not torch.equal(a, c)
    values = set(img.flatten().tolist()) | {0.0}
    assert set(a.flatten().tolist()) <= values
