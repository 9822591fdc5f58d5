"""The port's fused out-projection and fused MLP against clibd_tpu's Pallas
kernels, which run in interpret mode on the CPU as tests/test_pallas.py runs
them.  On a CPU tensor each op runs its kernel's plain version, so these
tests hold the plain versions (and the operators' gradients) to the TPU
kernels; tests/test_torch_kernels.py holds the CUDA kernels to the plain
versions on a card.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
Tolerances, each with its reason:
* out-projection values 2e-2, gradients 5e-2 (test_pallas.py:197-224): both
  sides round P, V and the context to bf16 after fp32 maths and read W_out
  as bf16, so a value within float noise of a bf16 rounding boundary may
  round the other way in one package;
* fused MLP in fp32: 1e-5 on values and 1e-3 on gradients
  (test_pallas.py:248-281), fp32 throughout on both sides;
* transformer stacks with a knob on: the fused out-projection carries the
  same bf16 roundings, so 2e-2 of the output's scale; the fused MLP in fp32
  1e-4 (test_pallas.py:284-302).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.models import layers as jl
from clibd_tpu.ops.pallas.attention import flash_attention_qkv_outproj as jax_outproj
from clibd_tpu.ops.pallas.mlp import _xla_mlp
from clibd_tpu.ops.pallas.mlp import fused_mlp as jax_fused_mlp
from clibd_tpu_torch.models import layers as tl
from clibd_tpu_torch.ops.attention import flash_attention_qkv_outproj
from clibd_tpu_torch.ops.cuda_build import CSRC
from clibd_tpu_torch.ops.mlp import fused_mlp, fused_mlp_reference
from clibd_tpu_torch.tools.exp_mlp_activation import FORMS, KERNEL_FORM, form_source

NEG = np.finfo(np.float32).min


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _outproj_inputs(seed, B=2, N=19, H=2):
    rng = np.random.default_rng(seed)
    D = H * 64
    qkv = (rng.standard_normal((B, N, 3 * D)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((D, D)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    mask = np.zeros((B, N), np.float32)
    mask[:, 14:] = NEG
    mask[0] = NEG  # batch row 0: every key masked
    return qkv, w, b, mask


# (masked, N, H): the first two keep their ids; then one key, one row past
# a 64-row query tile, and 12 heads (D = 768), each masked and not
@pytest.mark.parametrize("masked,N,H", [
    (False, 19, 2), (True, 19, 2), (False, 1, 2), (True, 1, 12), (True, 65, 2), (False, 65, 12)],
    ids=["False", "True", "N1-H2", "N1-H12-masked", "N65-H2-masked", "N65-H12"])
def test_outproj_matches_the_pallas_kernel(masked, N, H):
    qkv, w, b, mask = _outproj_inputs(0, N=N, H=H)
    m = mask if masked else None
    want = jax_outproj(jnp.asarray(qkv), jnp.asarray(w), jnp.asarray(b), H,
                       mask_row=None if m is None else jnp.asarray(m), interpret=True)
    got = flash_attention_qkv_outproj(torch.from_numpy(qkv), torch.from_numpy(w),
                                      torch.from_numpy(b), H,
                                      mask_row=None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == (2, N, H * 64)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def test_outproj_gradients_match_the_pallas_kernel():
    """qkv, W_out and bias gradients of sum(out^2), with the key mask; the
    JAX side takes its default backward (the Pallas backward kernel)."""
    qkv, w, b, mask = _outproj_inputs(1)

    def loss_jax(t, ww, bb):
        return (jax_outproj(t, ww, bb, 2, mask_row=jnp.asarray(mask), interpret=True) ** 2).sum()

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(jnp.asarray(qkv), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, w, b)]
    out = flash_attention_qkv_outproj(*leaves, 2, mask_row=torch.from_numpy(mask))
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for name, a, e in zip(("qkv", "out_w", "out_b"), got, want):
        assert a.shape == e.shape, name
        np.testing.assert_allclose(_np(a), _np(e), atol=5e-2, rtol=5e-2, err_msg=name)


def test_outproj_bf16_gradient_dtypes():
    """bf16 inputs: the output and every gradient keep their input's dtype."""
    qkv, w, b, _ = _outproj_inputs(2)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (qkv, w, b)]
    out = flash_attention_qkv_outproj(*leaves, 2)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert out.dtype == torch.bfloat16
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


def _mlp_inputs(seed, R=37, D=64, F=96):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((2, R, D)) * 0.5).astype(np.float32),
            (rng.standard_normal((D, F)) * 0.1).astype(np.float32),
            (rng.standard_normal(F) * 0.1).astype(np.float32),
            (rng.standard_normal((F, D)) * 0.1).astype(np.float32),
            (rng.standard_normal(D) * 0.1).astype(np.float32))


@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "quick_gelu"])
def test_fused_mlp_matches_the_pallas_kernel(activation):
    """Values of the plain version and of the operator, and all five
    gradients, against `fused_mlp(..., interpret=True)`; 2 x 37 rows is not a
    multiple of any of the TPU kernel's row blocks."""
    arrays = _mlp_inputs(3)
    x, w1, b1, w2, b2 = arrays
    D = x.shape[-1]
    want = jax_fused_mlp(*map(jnp.asarray, arrays), activation=activation, rows_block=16,
                         f_block=48, interpret=True)
    plain = fused_mlp_reference(*(torch.from_numpy(a) for a in (x.reshape(-1, D), w1, b1, w2, b2)),
                                activation)
    np.testing.assert_allclose(_np(plain).reshape(x.shape), _np(want), atol=1e-5, rtol=1e-5)

    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = fused_mlp(*leaves, activation=activation)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad((got ** 2).sum(), leaves)
    want_grads = jax.grad(
        lambda *a: (jax_fused_mlp(*a, activation=activation, rows_block=16, f_block=48,
                                  interpret=True) ** 2).sum(),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    for name, a, e in zip(("x", "w1", "b1", "w2", "b2"), grads, want_grads):
        np.testing.assert_allclose(_np(a), _np(e), atol=1e-3, rtol=1e-3, err_msg=name)


def test_fused_mlp_bf16_rounds_the_intermediate_like_the_reference():
    """bf16 inputs: the plain version equals `_xla_mlp` (bf16 h between two
    fp32-accumulated products) to one bf16 ulp of the output, at a small
    width and at the width the card's kernel runs (D=768, F=3072), where the
    plain version is the kernel's yardstick.  Both widths are cases of this
    one test, so that its id stays as it was."""
    for shape in ({}, {"R": 37, "D": 768, "F": 3072}):
        arrays = [a.reshape(-1, a.shape[-1]) if i == 0 else a
                  for i, a in enumerate(_mlp_inputs(4, **shape))]
        want = _xla_mlp(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays), "gelu_tanh")
        got = fused_mlp_reference(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays),
                                  "gelu_tanh")
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=2 ** -8 * float(np.abs(_np(want)).max()),
                                   err_msg=f"shape {shape or 'default'}")


def test_activation_harness_swaps_only_the_kernels_gelu_tanh_line():
    """`tools/exp_mlp_activation` rebuilds the bf16 kernel with its gelu_tanh
    line replaced: that line is the kernel's, found once, and every form's
    source is the kernel's with that line alone changed."""
    src = (CSRC / "fused_mlp.cu").read_text()
    assert src.count(KERNEL_FORM) == 1
    assert form_source("expf") == src
    for form in set(FORMS) - {"expf"}:
        swapped = form_source(form)
        assert KERNEL_FORM not in swapped and FORMS[form] in swapped
        assert swapped.replace(FORMS[form], KERNEL_FORM) == src


def test_fused_mlp_rejects_an_unknown_activation():
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _mlp_inputs(5))
    with pytest.raises(ValueError, match="activation"):
        fused_mlp(x, w1, b1, w2, b2, activation="relu")


def _stack_tree(seed, L=2, D=128, Fd=256):
    rng = np.random.default_rng(seed)

    def n(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {"qkv_w": n(L, D, 3 * D), "qkv_b": n(L, 3 * D), "out_w": n(L, D, D), "out_b": n(L, D),
            "fc1_w": n(L, D, Fd), "fc1_b": n(L, Fd), "fc2_w": n(L, Fd, D), "fc2_b": n(L, D),
            "ln1_scale": 1 + n(L, D), "ln1_bias": n(L, D), "ln2_scale": 1 + n(L, D),
            "ln2_bias": n(L, D)}


@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("knob", ["outproj", "mlp"])
def test_transformer_stack_with_a_knob_on_matches_jax(monkeypatch, knob, pre_ln):
    """transformer_stack with ATTN_FUSE_OUTPROJ or MLP_IMPL=pallas in both
    packages (the JAX side with its flash gate open, kernels in interpret
    mode), fp32, with a key mask; the port's stack counts one call of the
    fused op per layer."""
    tree = _stack_tree(6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 17, 128)).astype(np.float32)
    att = (rng.random((2, 17)) > 0.3).astype(np.int32)
    att[:, 0] = 1
    kwargs = dict(num_heads=2, pre_ln=pre_ln, ln_eps=1e-6)
    monkeypatch.setattr(jl, "ATTENTION_IMPL", "pallas")
    if knob == "outproj":
        monkeypatch.setattr(jl, "ATTN_FUSE_OUTPROJ", True)
        monkeypatch.setattr(tl, "ATTN_FUSE_OUTPROJ", True)
    else:
        monkeypatch.setattr(jl, "MLP_IMPL", "pallas")
        monkeypatch.setattr(tl, "MLP_IMPL", "pallas")
    want = jax.jit(lambda: jl.transformer_stack(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x),
        mask_bias=jl.attention_mask_bias(jnp.asarray(att)), compute_dtype=jnp.float32,
        **kwargs))()

    calls = []
    op = tl.flash_attention_qkv_outproj if knob == "outproj" else tl.fused_mlp
    monkeypatch.setattr(tl, op.__name__, lambda *a, **k: calls.append(1) or op(*a, **k))
    got = tl.transformer_stack({k: torch.from_numpy(v) for k, v in tree.items()},
                               torch.from_numpy(x),
                               mask_bias=tl.attention_mask_bias(torch.from_numpy(att)),
                               compute_dtype=torch.float32, **kwargs)
    assert len(calls) == 2
    scale = float(np.abs(_np(want)).max())
    tol = 2e-2 * scale if knob == "outproj" else 1e-4 * scale
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def test_knobs_default_off_and_kernel_knobs_restores_them():
    assert (tl.ATTN_FUSE_OUTPROJ, tl.MLP_IMPL) == (False, "xla")
    with tl.kernel_knobs(True, "pallas"):
        assert (tl.ATTN_FUSE_OUTPROJ, tl.MLP_IMPL) == (True, "pallas")
    assert (tl.ATTN_FUSE_OUTPROJ, tl.MLP_IMPL) == (False, "xla")


def test_remat_attn_saves_the_fused_outproj_and_recomputes_the_fused_mlp():
    """Under the "attn" policy the tagged out-projection output is saved
    (one forward per layer per step) and the fused MLP runs again in the
    recompute (two per layer); gradients equal the unrematerialised ones."""
    from clibd_tpu_torch.ops import attention, mlp

    tree = _stack_tree(8)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 11, 128)).astype(np.float32))
    counts = {"outproj": 0, "mlp": 0}

    def counted(fn, key):
        def run(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return run

    def grads(remat):
        params = {k: torch.from_numpy(v).requires_grad_() for k, v in tree.items()}
        out = tl.transformer_stack(params, x, num_heads=2, pre_ln=True, ln_eps=1e-6,
                                   compute_dtype=torch.float32, remat=remat)
        return torch.autograd.grad(out.square().sum(), list(params.values()))

    saved = attention.flash_attention_qkv_outproj_reference, mlp.fused_mlp_reference
    attention.flash_attention_qkv_outproj_reference = counted(saved[0], "outproj")
    mlp.fused_mlp_reference = counted(saved[1], "mlp")
    try:
        with tl.kernel_knobs(True, "pallas"):
            plain = grads(False)
            counts.update(outproj=0, mlp=0)
            rematted = grads("attn")
    finally:
        attention.flash_attention_qkv_outproj_reference, mlp.fused_mlp_reference = saved
    # per layer: one out-projection; the MLP forward, its recompute, and the
    # plain version that its backward differentiates
    assert counts == {"outproj": 2, "mlp": 6}
    for a, b in zip(plain, rematted):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
