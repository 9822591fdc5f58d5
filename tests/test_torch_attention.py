"""clibd_tpu_torch.ops.attention against clibd_tpu's flash attention.

The plain version (what a CPU tensor runs) is held against the Pallas kernel
run in interpret mode and against `_xla_attention_from_qkv`, on the same
numpy inputs, in fp32 and bf16, with and without a key mask, including a
fully masked row.  The CUDA kernel itself is held against the plain version
in `test_torch_kernels.py`, which runs only where there is a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clibd_tpu.ops.pallas import attention as jax_attention
from clibd_tpu_torch.ops.attention import flash_attention_qkv, flash_attention_qkv_reference

NEG = np.finfo(np.float32).min

# fp32 qkv: S and the softmax are fp32 on both sides, but P and V are rounded
# to bf16 on both sides, so a score that lands within float noise of a bf16
# rounding boundary may round the other way: one bf16 ulp of P (2^-8 of
# p <= 1) times |v| (< 5 for these normal inputs).  Typical differences are
# ~1e-6.
FP32_ATOL = 2e-2
FP32_MEAN_ATOL = 1e-4
# bf16 qkv: the output itself is bf16, so one bf16 ulp of |out| (< 4) on top.
BF16_ATOL = 4e-2


def _inputs(B, N, H, masked, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * 64)).astype(np.float32)
    mask = None
    if masked:
        keep = rng.random((B, N)) > 0.3
        keep[:, 0] = True
        if B > 1:
            keep[0] = False  # batch row 0: every key masked
        mask = np.where(keep, 0.0, NEG).astype(np.float32)
    return qkv, mask


def _port(qkv, mask, H, dtype):
    t = torch.from_numpy(qkv).to(dtype)
    m = None if mask is None else torch.from_numpy(mask)
    return flash_attention_qkv(t, H, m).float().numpy()


def _jax_pallas(qkv, mask, H, dtype):
    m = None if mask is None else jnp.asarray(mask)
    out = jax_attention.flash_attention_qkv(jnp.asarray(qkv, dtype), H, mask_row=m,
                                            block_b=1, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _jax_xla(qkv, mask, H, dtype):
    m = None if mask is None else jnp.asarray(mask)
    out = jax_attention._xla_attention_from_qkv(jnp.asarray(qkv, dtype), m, H, qkv.shape[1])
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("N,H,masked", [(13, 2, False), (20, 2, True), (17, 1, True),
                                         (657, 2, False), (657, 2, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_plain_version_matches_jax(N, H, masked, dtype, ref):
    """N=657 is the overlap-tokenizer DNA tower's length, at one batch row."""
    qkv, mask = _inputs(1 if N > 256 else 2, N, H, masked, seed=N)
    tdtype = getattr(torch, dtype)
    jdtype = getattr(jnp, dtype)
    got = _port(qkv, mask, H, tdtype)
    want = (_jax_pallas if ref == "pallas_interpret" else _jax_xla)(qkv, mask, H, jdtype)
    diff = np.abs(got - want)
    assert diff.max() <= (FP32_ATOL if dtype == "float32" else BF16_ATOL)
    if dtype == "float32":
        assert diff.mean() <= FP32_MEAN_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fully_masked_row_is_uniform_over_keys(dtype):
    """Every key of batch row 0 is masked: each query's output is the mean of
    V over all N keys (P = bf16(1/N) everywhere), as in the reference."""
    N, H = 20, 2
    qkv, mask = _inputs(2, N, H, True, seed=3)
    got = _port(qkv, mask, H, dtype)
    v = torch.from_numpy(qkv).to(dtype)[0, :, 2 * H * 64:].to(torch.bfloat16).float()
    p = torch.tensor(1.0 / N).to(torch.bfloat16).float()
    want = (p * v.sum(0, keepdim=True)).expand(N, -1).numpy()
    np.testing.assert_allclose(got[0], want, atol=1e-5 if dtype == torch.float32 else 2e-2)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    qkv, mask = _inputs(2, 13, 2, True, seed=5)
    t, m = torch.from_numpy(qkv), torch.from_numpy(mask)
    before = flash_attention_qkv.launches
    out = flash_attention_qkv(t, 2, m)
    assert torch.equal(out, flash_attention_qkv_reference(t, 2, m))
    assert out.dtype == t.dtype and out.shape == (2, 13, 128)
    assert flash_attention_qkv.launches == before
