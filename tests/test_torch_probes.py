"""The chip-probe kernels of the port against the Pallas kernels of the
experiment scripts `tools/exp_attn.py`, `tools/exp_mxu.py` and
`tools/exp_mxu2.py`, which run in TPU interpret mode on the CPU
(`pltpu.force_tpu_interpret_mode`).  On a CPU tensor each port op runs its
kernel's plain version, so these tests hold the plain versions to the TPU
kernels; tests/test_torch_kernels.py holds the CUDA kernels to the plain
versions on a card.  The ported harnesses' argument parsing and variant
tables are checked without a card.

`tools/` is not a package: the scripts are imported by path.  Their size
constants are module globals read at trace time, so monkeypatch shrinks
them; the copy and matmul probes are closures, captured by replacing the
script's `timeit` with a stub that records the jitted function.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
Tolerances, each with its reason:
* scale copy: exact -- one fp32 multiply by 2 rounds nothing;
* GEMM, fp32 out: max|Δ| <= 1e-4 * max|ref| -- the bf16 products are exact
  in fp32 on both sides, and only the order of the fp32 sums differs;
* GEMM, bf16 out: max|Δ| <= 8e-3 * max|ref| -- the same sums, then one
  bf16 rounding (2^-8 relative) that a sum-order difference can flip;
* attention: max|Δ| <= 2e-2 on unit-scale bf16 inputs -- both sides round
  P to bf16 after fp32 maths, so a probability within float noise of a bf16
  boundary may round the other way (one bf16 ulp of P times |v|), and the
  output is bf16.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clibd_tpu_torch.ops.attention import attention_bhnd
from clibd_tpu_torch.ops.elementwise import scale_copy
from clibd_tpu_torch.ops.gemm import OUT_DTYPES, TILES, tiled_matmul
from clibd_tpu_torch.tools import exp_attn, exp_mxu, exp_mxu2

REPO = Path(__file__).resolve().parents[1]
GEMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
ATTN_TOL = 2e-2


def _script(name):
    """tools/<name>.py of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_exp_attn():
    return _script("exp_attn")


def _captured(monkeypatch, script, probe):
    """The jitted function that `probe()` hands to the script's timeit."""
    seen = []
    monkeypatch.setattr(script, "timeit", lambda fn, *args, **kw: seen.append(fn) or 1.0)
    with pltpu.force_tpu_interpret_mode():
        probe()
    assert len(seen) == 1
    return seen[0]


def _bf16_pair(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def test_scale_copy_matches_the_copy_probe(monkeypatch, jax_exp_attn):
    run = _captured(monkeypatch, jax_exp_attn, jax_exp_attn.probe_pallas_bandwidth)
    x = np.random.default_rng(0).standard_normal((8192, 2048), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(run(jnp.asarray(x)))
    got = scale_copy(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 3, 1027])
def test_scale_copy_plain_version_takes_any_length(n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n, dtype=np.float32))
    assert torch.equal(scale_copy(x, 3.0), x * 3.0)


def test_gemm_matches_the_matmul_probe(monkeypatch, jax_exp_attn):
    run = _captured(monkeypatch, jax_exp_attn, jax_exp_attn.probe_pallas_matmul)
    rng = np.random.default_rng(1)
    (ja, ta), (jb, tb) = _bf16_pair(rng, (1024, 1024)), _bf16_pair(rng, (1024, 1024))
    with pltpu.force_tpu_interpret_mode():
        want = run(ja, jb)
    got = tiled_matmul(ta, tb, exp_attn.PROBE_TILE)
    assert got.dtype == torch.float32 and got.shape == (1024, 1024)
    _close(got, want, GEMM_TOL[torch.float32])


def test_gemm_matches_exp_mxu_tiled(monkeypatch):
    script = _script("exp_mxu")
    for name in ("M", "N", "K"):
        monkeypatch.setattr(script, name, 512)
    rng = np.random.default_rng(2)
    (ja, ta), (jb, tb) = _bf16_pair(rng, (512, 512)), _bf16_pair(rng, (512, 512))
    with pltpu.force_tpu_interpret_mode():
        want = script.make_tiled(256, 256)(ja, jb)
    _close(tiled_matmul(ta, tb, "t128x128x64"), want, GEMM_TOL[torch.float32])


@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=["fp32", "bf16"])
def test_gemm_matches_exp_mxu2_tiled(monkeypatch, out_dtype):
    script = _script("exp_mxu2")
    for name in ("M", "N", "K"):
        monkeypatch.setattr(script, name, 512)
    rng = np.random.default_rng(3)
    (ja, ta), (jb, tb) = _bf16_pair(rng, (512, 512)), _bf16_pair(rng, (512, 512))
    out_bf16 = out_dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        # tk = 256: two k steps through the accumulator scratch
        want = script.make_tiled(256, 256, 256, out_bf16, out_bf16)(ja, jb)
    got = tiled_matmul(ta, tb, "t64x64x64", out_dtype)
    assert got.dtype == out_dtype
    _close(got, want, GEMM_TOL[out_dtype])


@pytest.mark.parametrize("N", [1, 20, 64, 133, 256])
def test_attention_bhnd_matches_make_pallas_attn(monkeypatch, jax_exp_attn, N):
    for name, value in (("B", 2), ("H", 2), ("N", N)):
        monkeypatch.setattr(jax_exp_attn, name, value)
    rng = np.random.default_rng(N)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (2, 2, N, 64)) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = jax_exp_attn.make_pallas_attn(1, 256, False)(jq, jk, jv)
    got = attention_bhnd(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, N, 64)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert float(np.abs(got.float().numpy() - want).max()) <= ATTN_TOL


def test_tiles_mirror_the_cuda_source():
    """ops/gemm.TILES names exactly the instantiations of csrc/tiled_gemm.cu,
    with their (BM, BN, BK, warps, stages): CLIBD_GEMM_TILE(name, BM, BN,
    BK, CTAs of a cluster, consumer warpgroups, stages), a producer warp a
    CTA."""
    src = (REPO / "clibd_tpu_torch/csrc/tiled_gemm.cu").read_text()
    found = {m[0]: (int(m[1]), int(m[2]), int(m[3]), 4 * int(m[5]) + 1, int(m[6]))
             for m in re.findall(r"^CLIBD_GEMM_TILE\((\w+), (\d+), (\d+), (\d+), ([12]), (\d+), "
                                 r"(\d+)\)", src, re.M)}
    assert found == TILES
    assert 2 <= len(TILES) <= 6
    assert "t64x64x64" in TILES and any(t[:2] == (128, 128) for t in TILES.values())
    assert all(t[2] == 64 for t in TILES.values())  # a slot is one 128-byte swizzled row deep


@pytest.mark.parametrize("a_shape,b_shape,tile,dtype,error", [
    ((1000, 1024), (1024, 1024), "t64x64x64", torch.float32, ValueError),
    ((1024, 1000), (1000, 1024), "t64x64x64", torch.float32, ValueError),
    ((128, 64), (64, 192), "t128x256x64", torch.float32, ValueError),
    ((64, 64), (64, 64), "t64x64x32", torch.float32, ValueError),
    ((64, 64), (64, 64), "t64x64x64", torch.float16, TypeError),
])
def test_gemm_refuses_what_the_kernel_does_not_take(a_shape, b_shape, tile, dtype, error):
    """Shapes off the tile raise on the CPU as on the card, before any
    product (the TPU grid is M // tm)."""
    a = torch.zeros(a_shape, dtype=torch.bfloat16)
    b = torch.zeros(b_shape, dtype=torch.bfloat16)
    with pytest.raises(error):
        tiled_matmul(a, b, tile, dtype)


def test_harness_variant_tables():
    assert exp_mxu.VARIANTS == [(t, d) for t in TILES for d in OUT_DTYPES]
    assert list(exp_mxu2.VARIANTS) == ["cublas"] + [n for t in TILES for n in (t, f"{t}_bf16out")]
    assert all(exp_mxu2.VARIANTS[f"{t}_bf16out"] == (t, torch.bfloat16) for t in TILES)
    assert (exp_mxu.M, exp_mxu2.M, exp_attn.MATMUL_SIZE) == (2048, 8192, 1024)
    assert (exp_attn.B, exp_attn.H, exp_attn.N, exp_attn.HD) == (256, 12, 197, 64)
    assert exp_attn.PROBE_TILE in TILES


def test_harness_argument_parsing():
    assert exp_attn.parse_args([]).mode == "all"
    for mode in exp_attn.MODES:
        assert exp_attn.parse_args([mode]).mode == mode
    assert exp_mxu2.parse_args([]).variants == []
    assert exp_mxu2.parse_args(["cublas", "t64x64x64_bf16out"]).variants == \
        ["cublas", "t64x64x64_bf16out"]
    for bad in (lambda: exp_attn.parse_args(["flash"]),
                lambda: exp_mxu2.parse_args(["t512x512x512"])):
        with pytest.raises(SystemExit):
            bad()


@pytest.mark.parametrize("tool,argv", [(exp_attn, ["probe"]), (exp_mxu, []),
                                       (exp_mxu2, ["cublas"])])
def test_harnesses_need_a_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness would run")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tool.main(argv)
