"""LayerNorm: the plain version, its backward formula and the registered
operator on the CPU; the hand-written kernels (`csrc/layernorm.cu`) against
the plain versions on the card.

The file imports neither jax nor `tests/conftest.py`'s fixtures, so the card
tests run on a machine with PyTorch for CUDA and no jax:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_layernorm.py -m cuda -q
"""

import functools

import pytest
import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from clibd_tpu_torch.models import layers
from clibd_tpu_torch.ops import layernorm as ln
from clibd_tpu_torch.ops.layernorm import (
    layernorm,
    layernorm_bwd,
    layernorm_bwd_reference,
    layernorm_reference,
    layernorm_stats_reference,
)

# the three paths: (x's dtype, fast)
PATHS = [(torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, False)]
PATH_IDS = ["bf16-fast", "bf16-exact", "fp32-exact"]
# the exact path against autograd through the plain forward, fp32: both are
# fp32 arithmetic of the same gradient, summed in other orders
FP32_REL_TOL = 1e-5
# bf16, relative to the largest entry: dx rounds once to bf16 (2^-8) here,
# while autograd through the plain version also rounds its intermediate
# gradients to bf16 (the fast path's xc * inv, * scale and the mean's
# gradient, each a rounding of 2^-8 on terms that partly cancel)
BF16_REL_TOL = 3e-2
# the kernel against the plain version on the card, bf16 output, relative to
# its largest entry: both round at the same points, so they differ where an
# fp32 sum in another order rounds the mean, the inverse std or an element
# to the other side of a bf16 boundary
KERNEL_BF16_REL_TOL = 1e-2
# and the share of elements equal bit for bit
KERNEL_BF16_SAME = 0.97


def _draw(shape, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3 + 1
    D = shape[-1]
    scale = torch.randn(D, generator=g) * 0.5 + 1
    bias = torch.randn(D, generator=g)
    return x.to(device, dtype), scale.to(device), bias.to(device)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _seed_layernorm(x, scale, bias, eps, fast):
    """The port's LayerNorm as it was before the kernel, op for op."""
    if fast and x.dtype != torch.float32:
        mean = x.float().mean(dim=-1, keepdim=True).to(x.dtype)
        xc = x - mean
        var = xc.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return xc * inv * scale.to(x.dtype) + bias.to(x.dtype)
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,fast", PATHS, ids=PATH_IDS)
def test_cpu_tensor_runs_the_plain_version_bit_for_bit(dtype, fast):
    x, scale, bias = _draw((3, 7, 96), dtype, 0)
    want = _seed_layernorm(x, scale, bias, 1e-6, fast)
    for got in (layers.layernorm(x, scale, bias, 1e-6, fast=fast),
                layernorm_reference(x, scale, bias, 1e-6, fast),
                layernorm_stats_reference(x, scale, bias, 1e-6, fast)[0],
                torch.ops.clibd.layernorm(x, scale, bias, 1e-6, fast)[0]):
        assert got.dtype == dtype
        assert torch.equal(got, want)


def test_stats_are_what_the_fast_path_normalised_with():
    x, scale, bias = _draw((5, 64), torch.bfloat16, 1)
    _, mean, rstd = layernorm_stats_reference(x, scale, bias, 1e-12, True)
    assert mean.dtype == rstd.dtype == torch.float32 and mean.shape == (5,)
    # rounded to bf16, as the plain fast path uses them
    assert torch.equal(mean, mean.to(torch.bfloat16).float())
    assert torch.equal(rstd, rstd.to(torch.bfloat16).float())
    xc = x - mean[:, None].to(torch.bfloat16)
    assert torch.equal(xc.float().square().mean(-1).add(1e-12).rsqrt().to(torch.bfloat16).float(),
                       rstd)


@pytest.mark.parametrize("dtype,fast", PATHS, ids=PATH_IDS)
def test_plain_backward_formula_matches_autograd(dtype, fast):
    x, scale, bias = _draw((6, 9, 128), dtype, 2)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(dtype)
    xs, ss, bs = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    want = torch.autograd.grad(layernorm_reference(xs, ss, bs, 1e-6, fast), (xs, ss, bs), dy)
    _, mean, rstd = layernorm_stats_reference(x, scale, bias, 1e-6, fast)
    got = layernorm_bwd_reference(x, dy, scale, mean, rstd, fast)
    tol = FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
    for g, w, name in zip(got, want, ("dx", "dscale", "dbias")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    if not fast:  # autograd sums dbias in fp32 too (on the fast path, in bf16)
        assert torch.allclose(got[2], want[2], rtol=1e-6, atol=1e-5)


def test_the_operator_passes_opcheck():
    x, scale, bias = _draw((4, 5, 32), torch.bfloat16, 4)
    for fast in (True, False):
        torch.library.opcheck(
            torch.ops.clibd.layernorm.default,
            (x.requires_grad_(True), scale.requires_grad_(True), bias.requires_grad_(True),
             1e-6, fast),
            test_utils=("test_schema", "test_autograd_registration", "test_faketensor"))


def _op_grads(x, scale, bias, dy, remat):
    """Gradients of two LayerNorms through the operator, one after the other
    (the second input depends on the first's output), with the pair run
    plainly or under `torch.utils.checkpoint` (remat True) or a selective
    policy."""
    xs, ss, bs = (t.clone().requires_grad_(True) for t in (x, scale, bias))

    def pair(h, s, b):
        h = torch.ops.clibd.layernorm(h, s, b, 1e-6, True)[0]
        return torch.ops.clibd.layernorm(h * 2, s, b, 1e-6, True)[0]

    if remat is False:
        out = pair(xs, ss, bs)
    else:
        policy = layers.remat_policy(remat)
        kwargs = ({} if policy is None else
                  {"context_fn": functools.partial(create_selective_checkpoint_contexts, policy)})
        out = checkpoint(pair, xs, ss, bs, use_reentrant=False, **kwargs)
    return torch.autograd.grad(out, (xs, ss, bs), dy)


@pytest.mark.parametrize("remat", [True, "attn", "dots"])
def test_operator_autograd_under_checkpoint(remat):
    x, scale, bias = _draw((3, 11, 64), torch.bfloat16, 5)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
    want = _op_grads(x, scale, bias, dy, False)
    got = _op_grads(x, scale, bias, dy, remat)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_operator_backward_is_the_plain_formula():
    x, scale, bias = _draw((2, 7, 48), torch.bfloat16, 7)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(8)).to(torch.bfloat16)
    xs, ss, bs = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    got = torch.autograd.grad(torch.ops.clibd.layernorm(xs, ss, bs, 1e-6, True)[0],
                              (xs, ss, bs), dy)
    _, mean, rstd = layernorm_stats_reference(x, scale, bias, 1e-6, True)
    for g, w in zip(got, layernorm_bwd(x, dy, scale, mean, rstd, True)):
        assert torch.equal(g, w)


def test_a_transformer_stack_trains_through_the_operator_under_remat(monkeypatch):
    """The tower's blocks with every LayerNorm sent through the operator (as
    on a CUDA tensor) give the plain version's gradients under remat "attn",
    to the backward formula's bf16 tolerance."""
    L, D, Fd, H = 2, 64, 128, 2
    stack = layers.TransformerStack(L, D, Fd)
    stack.reset_parameters(torch.Generator().manual_seed(9))
    with torch.no_grad():
        for name in ("ln1_scale", "ln2_scale", "ln1_bias", "ln2_bias"):
            getattr(stack, name).add_(torch.randn(L, D, generator=torch.Generator()
                                                  .manual_seed(10)) * 0.1)
    x = torch.randn(2, 9, D, generator=torch.Generator().manual_seed(11)).to(torch.bfloat16)

    def grads():
        stack.zero_grad(set_to_none=True)
        xs = x.clone().requires_grad_(True)
        out = stack(xs, num_heads=H, pre_ln=True, ln_eps=1e-6, remat="attn")
        out.float().square().sum().backward()
        return [xs.grad] + [getattr(stack, n).grad for n in layers.BLOCK_KEYS]

    want = grads()
    monkeypatch.setattr(layers, "layernorm", lambda x, s, b, eps=1e-12, fast=False:
                        torch.ops.clibd.layernorm(x, s, b, eps, fast)[0])
    got = grads()
    for g, w, name in zip(got, want, ("x",) + layers.BLOCK_KEYS):
        cos = float((g.float() * w.float()).sum() / (g.float().norm() * w.float().norm()))
        assert cos > 0.999, (name, cos)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _check_forward(x, scale, bias, eps, fast):
    """Kernel against the plain version on the card: y, mean, rstd."""
    got = ln.layernorm_cuda(x, scale, bias, eps, fast)
    want = layernorm_stats_reference(x, scale, bias, eps, fast)
    y, wy = got[0], want[0]
    assert y.dtype == x.dtype and y.shape == x.shape
    if x.dtype == torch.float32:
        assert _rel(y, wy) <= FP32_REL_TOL
    else:
        assert _rel(y, wy) <= KERNEL_BF16_REL_TOL
        assert float((y == wy).float().mean()) >= KERNEL_BF16_SAME
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == x.shape[:-1]
        assert _rel(g, w) <= (FP32_REL_TOL if not fast else 2 ** -7)
    return got


def _check_backward(x, scale, mean, rstd, fast, seed):
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed)).to(x.device, x.dtype)
    got = ln.layernorm_bwd_cuda(x, dy, scale, mean, rstd, fast)
    want = layernorm_bwd_reference(x, dy, scale, mean, rstd, fast)
    tol = FP32_REL_TOL * 10 if x.dtype == torch.float32 else KERNEL_BF16_REL_TOL
    assert got[0].dtype == x.dtype and got[0].shape == x.shape
    assert _rel(got[0], want[0]) <= tol
    for g, w in zip(got[1:], want[1:]):  # fp32 sums over the rows in another order
        assert g.dtype == torch.float32 and _rel(g, w) <= FP32_REL_TOL * 10
    return dy, got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fast", PATHS, ids=PATH_IDS)
@pytest.mark.parametrize("D", [512, 768, 1024])
def test_kernel_matches_plain_version(cuda_device, D, dtype, fast):
    x, scale, bias = _draw((1003, D), dtype, D, cuda_device)
    _, mean, rstd = _check_forward(x, scale, bias, 1e-6, fast)
    _check_backward(x, scale, mean, rstd, fast, D + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 7, 33, 8 * 132 * 4 + 5])
def test_kernel_at_ragged_row_counts(cuda_device, R):
    for dtype, fast in PATHS:
        x, scale, bias = _draw((R, 768), dtype, R, cuda_device)
        _, mean, rstd = _check_forward(x, scale, bias, 1e-12, fast)
        _check_backward(x, scale, mean, rstd, fast, R + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fast", PATHS, ids=PATH_IDS)
def test_kernel_reads_the_class_row_in_place(cuda_device, dtype, fast):
    """x[:, 0] of [B, N, D], the ViT's class row: strided rows, no copy, the
    same results as on the contiguous rows."""
    tokens, scale, bias = _draw((37, 197, 768), dtype, 12, cuda_device)
    cls = tokens[:, 0]
    assert not cls.is_contiguous()
    y, mean, rstd = _check_forward(cls, scale, bias, 1e-6, fast)
    y2, mean2, rstd2 = ln.layernorm_cuda(cls.contiguous(), scale, bias, 1e-6, fast)
    assert torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(rstd, rstd2)
    dy, got = _check_backward(cls, scale, mean, rstd, fast, 13)
    for g, w in zip(got, ln.layernorm_bwd_cuda(cls.contiguous(), dy, scale, mean, rstd, fast)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("D,pad", [(100, 0), (2048, 0), (1024, 0), (768, 1)],
                         ids=["D100", "D2048", "D1024", "D768-stride769"])
def test_kernel_any_width_path(cuda_device, D, pad):
    """Widths off the 16-byte vector or past the registers (fp32 D=1024
    included), and a row stride off the vector: the element-wise path."""
    for dtype, fast in PATHS:
        wide, scale, bias = _draw((301, D + pad), dtype, D, cuda_device)
        x = wide[:, :D]
        scale, bias = scale[:D].contiguous(), bias[:D].contiguous()
        _, mean, rstd = _check_forward(x, scale, bias, 1e-5, fast)
        _check_backward(x, scale, mean, rstd, fast, D + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fast", PATHS, ids=PATH_IDS)
def test_backward_kernel_is_deterministic(cuda_device, dtype, fast):
    x, scale, bias = _draw((500 * 197, 768), dtype, 14, cuda_device)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(15)).to(cuda_device, dtype)
    y, mean, rstd = ln.layernorm_cuda(x, scale, bias, 1e-6, fast)
    assert torch.equal(y, ln.layernorm_cuda(x, scale, bias, 1e-6, fast)[0])
    first = ln.layernorm_bwd_cuda(x, dy, scale, mean, rstd, fast)
    second = ln.layernorm_bwd_cuda(x, dy, scale, mean, rstd, fast)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_launch_counters(cuda_device):
    x, scale, bias = _draw((4, 197, 768), torch.bfloat16, 16, cuda_device)
    xs, ss, bs = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    f0, b0 = layernorm.launches, layernorm_bwd.launches
    y = layers.layernorm(xs, ss, bs, 1e-6, fast=True)
    assert (layernorm.launches - f0, layernorm_bwd.launches - b0) == (1, 0)
    y.float().sum().backward()
    assert (layernorm.launches - f0, layernorm_bwd.launches - b0) == (1, 1)
    assert xs.grad is not None and ss.grad.dtype == torch.float32 and bs.grad is not None
    # every LayerNorm of a pre-LN stack under remat "attn": 2 a block forward,
    # the same 2 recomputed in the backward, and 2 backward
    L = 3
    stack = layers.TransformerStack(L, 768, 3072)
    stack.reset_parameters(torch.Generator().manual_seed(17))
    stack = stack.to(cuda_device)
    h = x.clone().requires_grad_(True)
    f0, b0 = layernorm.launches, layernorm_bwd.launches
    out = stack(h, num_heads=12, pre_ln=True, ln_eps=1e-6, remat="attn")
    assert layernorm.launches - f0 == 2 * L
    out.float().sum().backward()
    assert (layernorm.launches - f0, layernorm_bwd.launches - b0) == (4 * L, 2 * L)
