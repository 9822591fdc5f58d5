"""The fused-qkv attention schedules of the port against the Pallas kernels
of the experiment script `tools/exp_flash.py` (`_phased_kernel`,
`_batched_kernel`, `_phased_bwd_kernel`), which its own `call_variant` and
`call_bwd_variant` run in interpret mode on a CPU backend.  On a CPU tensor
each port op (`flash_attention_qkv_phased`, `flash_attention_qkv_batched`,
`flash_attention_qkv_bwd_phased`) runs its kernel's plain version, so these
tests hold the plain versions to the JAX variants;
tests/test_torch_kernels.py holds the CUDA kernels to the plain versions on
a card.  The ported harness's argument parsing and mode table, and its rule
that a head group whose shared memory does not fit is reported and not
launched, are checked without a card.

`tools/` is not a package: the script is imported by path.  Inputs are
drawn with numpy from fixed seeds and handed to both packages; B=3 with
block_b 2 makes the script pad the batch.  Tolerances, each with its reason:
* forward: max|Δ| <= 2e-2 on unit-scale inputs -- both sides round P to
  bf16 after fp32 maths, so a probability within float noise of a bf16
  boundary may round the other way (one bf16 ulp of P times |v|), and a
  bf16 output rounds once more;
* backward: max|Δ| <= 2e-2 * max|ref| for each of dq, dk, dv -- the same
  bf16 rounding points (Pb, dS, the inputs), with sums in another order.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clibd_tpu_torch.ops import attention
from clibd_tpu_torch.ops.attention import (
    flash_attention_qkv_batched,
    flash_attention_qkv_bwd_phased,
    flash_attention_qkv_phased,
)
from clibd_tpu_torch.tools import exp_flash

REPO = Path(__file__).resolve().parents[1]
NEG = np.finfo(np.float32).min
FWD_TOL = 2e-2
BWD_REL_TOL = 2e-2
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (jnp.float32, torch.float32)}
# (dtype, heads, N, masked, block_b): every dtype, H in {2, 4}, N in {20
# masked, 37, 64, 256 masked (the most keys the CUDA kernels take)} and
# block_b in {1, 2} at least once; masked cases have batch row 0 fully masked
CASES = [("bf16", 2, 20, True, 2), ("fp32", 4, 20, True, 1), ("bf16", 4, 37, False, 1),
         ("fp32", 2, 37, False, 2), ("bf16", 2, 64, False, 1), ("fp32", 4, 64, True, 2),
         ("bf16", 2, 256, True, 1)]


@pytest.fixture(scope="module")
def jax_exp_flash():
    spec = importlib.util.spec_from_file_location("jax_tools_exp_flash",
                                                  REPO / "tools" / "exp_flash.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(B, N, H, masked, seed):
    """qkv [B, N, 3*H*64], dO [B, N, H*64], and a random key mask with batch
    row 0 fully masked (or None)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * 64)).astype(np.float32)
    dout = rng.standard_normal((B, N, H * 64)).astype(np.float32)
    mask = None
    if masked:
        keep = rng.random((B, N)) > 0.3
        keep[:, 0] = True
        keep[0] = False
        mask = np.where(keep, 0.0, NEG).astype(np.float32)
    return qkv, dout, mask


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("variant", ["phased", "batched"])
@pytest.mark.parametrize("dtype,H,N,masked,block_b", CASES)
def test_forward_plain_version_matches_the_jax_variant(jax_exp_flash, variant, dtype, H, N,
                                                       masked, block_b):
    qkv, _, mask = _inputs(3, N, H, masked, seed=N + H)
    jq, tq = _pair(qkv, dtype)
    want = jax_exp_flash.call_variant(jax_exp_flash.VARIANTS[variant], jq, H,
                                      mask_row=None if mask is None else jnp.asarray(mask),
                                      block_b=block_b)
    port = {"phased": flash_attention_qkv_phased, "batched": flash_attention_qkv_batched}[variant]
    got = port(tq, H, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tq.dtype and got.shape == (3, N, H * 64)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert float(np.abs(got.float().numpy() - want).max()) <= FWD_TOL
    if masked:  # the fully masked row is uniform over every key: the mean of V
        v = tq[0, :, 2 * H * 64:].to(torch.bfloat16).float().mean(0)
        assert float((got[0].float() - v).abs().max()) <= FWD_TOL


@pytest.mark.parametrize("dtype,H,N,masked,block_b", CASES)
def test_backward_plain_version_matches_the_phased_bwd_kernel(jax_exp_flash, dtype, H, N,
                                                              masked, block_b):
    qkv, dout, mask = _inputs(3, N, H, masked, seed=N + H + 1)
    (jq, tq), (jg, tg) = _pair(qkv, dtype), _pair(dout, dtype)
    want = jax_exp_flash.call_bwd_variant(jax_exp_flash._phased_bwd_kernel, jq, jg, H,
                                          mask_row=None if mask is None else jnp.asarray(mask),
                                          block_b=block_b)
    got = flash_attention_qkv_bwd_phased(tq, tg, H, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = np.asarray(jnp.asarray(want, jnp.float32))
    D = H * 64
    for i, part in enumerate(("dq", "dk", "dv")):
        a, b = got[..., i * D:(i + 1) * D].float().numpy(), want[..., i * D:(i + 1) * D]
        assert float(np.abs(a - b).max()) <= BWD_REL_TOL * float(np.abs(b).max()), part


def test_the_schedules_share_the_plain_versions(jax_exp_flash):
    """The JAX script's parity reference is the production forward, and its
    bwd_parity reference the production backward: the port's plain versions
    of the three kernels are those of kernels 1 and 2."""
    qkv, dout, mask = _inputs(2, 20, 2, True, seed=3)
    t, g, m = torch.from_numpy(qkv), torch.from_numpy(dout), torch.from_numpy(mask)
    want = attention.flash_attention_qkv_reference(t, 2, m)
    assert torch.equal(flash_attention_qkv_phased(t, 2, m, 1), want)
    assert torch.equal(flash_attention_qkv_batched(t, 2, m), want)
    assert torch.equal(flash_attention_qkv_bwd_phased(t, g, 2, m),
                       attention.flash_attention_qkv_bwd_reference(t, g, 2, m))
    assert set(jax_exp_flash.VARIANTS) == set(exp_flash.VARIANTS)


@pytest.mark.parametrize("heads_per_phase", [-1, 3, 5])
def test_phased_refuses_a_group_that_does_not_divide_the_heads(heads_per_phase):
    with pytest.raises(ValueError, match="divide"):
        flash_attention_qkv_phased(torch.zeros(1, 4, 3 * 4 * 64), 4, None, heads_per_phase)


def test_harness_argument_parsing_and_mode_table(jax_exp_flash):
    assert list(exp_flash.MODES) == ["parity", "bwd_parity", "time", "bwd_time", "fwd_group"]
    args = exp_flash.parse_args([])
    assert (args.mode, args.ints) == ("parity", [])
    assert exp_flash.parse_args(["time"]).ints == [2, 4, 8]
    assert exp_flash.parse_args(["bwd_time"]).ints == [2, 4]
    assert exp_flash.parse_args(["fwd_group"]).ints == [0, 2, 3, 4, 6]
    assert exp_flash.parse_args(["fwd_group", "0", "-1", "12"]).ints == [0, -1, 12]
    assert exp_flash.parse_args(["time", "2"]).ints == [2]
    for bad in (["flash"], ["time", "x"]):
        with pytest.raises(SystemExit):
            exp_flash.parse_args(bad)
    # the JAX script's shapes and tolerance
    assert (exp_flash.H, exp_flash.HD, exp_flash.SHAPES) == (12, 64, ((197, False), (133, True)))
    assert (exp_flash.PARITY_B, exp_flash.TIME_B, exp_flash.TOL) == (5, 256, 2e-2)


def test_harness_inputs_follow_the_jax_script():
    qkv, mask, g = exp_flash.draw(np.random.default_rng(0), 2, 133, True, "cpu", dout=True)
    rng = np.random.default_rng(0)
    want = rng.standard_normal((2, 133, 3 * 768)).astype(np.float32)
    assert torch.equal(qkv, torch.from_numpy(want).to(torch.bfloat16))
    assert g.shape == (2, 133, 768) and g.dtype == torch.bfloat16
    assert bool((mask[:, -9:] == NEG).all()) and bool((mask[:, :-9] == 0).all())


def test_fwd_group_reports_a_group_that_does_not_fit_and_launches_nothing(monkeypatch):
    """A head group is launched only when the wrapper's shared-memory query
    fits the card's limit; others are rows saying so, and g=-1 has no
    counterpart.  Run on CPU tensors (the plain version), with the query,
    the limit and the timer stubbed."""
    monkeypatch.setattr(exp_flash, "smem_limit", lambda device: 100_000)
    monkeypatch.setattr(exp_flash, "phased_smem_bytes", lambda N, H, G: 0 if G == 5 else 40_000 * G)
    timed = []

    def timer(fn):
        timed.append(fn())
        return 1.0

    monkeypatch.setattr(exp_flash, "cuda_ms", timer)
    calls = []
    real = exp_flash.flash_attention_qkv_phased
    monkeypatch.setattr(exp_flash, "flash_attention_qkv_phased",
                        lambda *a: calls.append(a[-1]) or real(*a))
    rows = exp_flash.fwd_group([0, 2, 3, 5, -1, 1], device="cpu", B=1)
    assert [(r["N"], r["group"], r["fits"]) for r in rows] == [
        (N, g, g in (2, 1)) for N, _ in exp_flash.SHAPES for g in (0, 2, 3, 5, -1, 1)]
    assert calls == [2, 1, 2, 1] and len(timed) == 4
    refused = [r for r in rows if not r["fits"] and r["group"] == 3]
    assert all(r["smem"] == 120_000 and r["limit"] == 100_000 for r in refused)


def test_harness_modes_run_on_cpu_tensors(monkeypatch):
    """parity and bwd_parity through the plain versions (the CPU path of
    every wrapper) agree exactly, and every row is OK."""
    rows = exp_flash.parity(device="cpu", B=1) + exp_flash.bwd_parity(device="cpu", B=1)
    assert len(rows) == 6 and all(r["ok"] for r in rows)
    assert all(r["err"] == 0 for r in rows if r["mode"] == "parity")
    assert all(max(r["rel_plain"] + r["rel_v0"]) == 0 for r in rows if r["mode"] == "bwd_parity")


def test_harness_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness would run")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        exp_flash.main(["parity"])
