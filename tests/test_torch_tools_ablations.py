"""The encoder and attention harnesses of `clibd_tpu_torch/tools/` on the
CPU, against the JAX package's scripts in `tools/` (imported by path):

- `exp_block` and `exp_bert`: every variant's output equals the JAX
  script's `build(variant)` on the same weights and input, with both
  modules' shape globals patched small;
- `exp_bwd_floor table`: the floor is PERF.md's bound (14 B N D bytes,
  10 B H N^2 64 operations, over 3.35 TB/s and 989 TFLOP/s);
- `exp_prof`: its three modes' embeddings equal the JAX script's on the
  same weights and inputs at a tiny width;
- every harness that needs a card raises without one.

Tolerance of the ablations, bf16 against bf16: XLA and PyTorch round the
products and the bias adds at other points (XLA fuses a dot with its bias
add), so an element may lie a few bf16 ulps apart; at |h| ~ 4 an ulp is
2^-5, so outputs are held at max |port - jax| <= 2e-2 * max |jax|.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clibd_tpu_torch.config import schema as port_schema
from clibd_tpu_torch.tools import (bench_eval, bench_extract, bench_knn, bench_train, exp_bert,
                                   exp_block, exp_bwd_floor, exp_prof, rehearse, soak_extract,
                                   soak_serve, soak_train)

REPO = Path(__file__).resolve().parents[1]
BF16_REL = 2e-2
SMALL = {"B": 2, "L": 2, "N": 5, "D": 32, "H": 2, "HD": 16}


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _patch_small(monkeypatch, jmod, pmod, **extra):
    for name, value in {**SMALL, **extra}.items():
        monkeypatch.setattr(jmod, name, value)
    for name, value in {**SMALL, **extra}.items():
        monkeypatch.setattr(pmod, "FF" if name == "F" else name, value)


def _hold(got: torch.Tensor, want, what: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= BF16_REL * scale, (what, err, scale)


@pytest.mark.parametrize("variant", ["base", "bnhd", "lnbf16", "tanh", "best", "bnhd_lnbf16",
                                     "bnhd_tanh"])
def test_exp_block_variant_equals_jax(monkeypatch, variant):
    jmod = _script("exp_block")
    _patch_small(monkeypatch, jmod, exp_block, F=64)
    params = exp_block.make_params("cpu")
    x = exp_block.make_input("cpu")
    jparams = jmod.make_params()
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]), err_msg=k)
    jx = jnp.asarray(np.random.default_rng(1).standard_normal((2, 5, 32), dtype=np.float32))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    _hold(exp_block.build(variant)(params, x), jmod.build(variant)(jparams, jx), variant)


@pytest.mark.parametrize("variant", ["base", "base_nohead", "fast", "fast_nohead"])
def test_exp_bert_variant_equals_jax(monkeypatch, variant):
    jmod = _script("exp_bert")
    _patch_small(monkeypatch, jmod, exp_bert, F=64, V=11)
    params = exp_bert.make_params("cpu")
    x, mask = exp_bert.make_inputs("cpu")
    jparams = jmod.make_params()
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]), err_msg=k)
    jx = jnp.asarray(x.numpy())
    jmask = jnp.ones((2, 5), jnp.int32)
    got = exp_bert.build(variant)(params, x, mask)
    want = jmod.build(variant)(jparams, jx, jmask)
    assert got.shape == ((2, 11) if not variant.endswith("_nohead") else (2, 5, 32))
    _hold(got, want, variant)


def test_exp_block_and_bert_mains_report_against_base_on_the_cpu(monkeypatch):
    monkeypatch.setattr(exp_block, "L", 1)
    monkeypatch.setattr(exp_block, "B", 2)
    rows = exp_block.main(["base", "tanh", "--device", "cpu"])
    assert [r["variant"] for r in rows] == ["base", "tanh"]
    assert rows[0]["max_abs_err_vs_base"] == 0.0 and rows[1]["ms"] is None
    assert rows[1]["max_abs_err_vs_base"] <= BF16_REL * rows[1]["base_max_abs"]
    monkeypatch.setattr(exp_bert, "L", 1)
    monkeypatch.setattr(exp_bert, "B", 2)
    rows = exp_bert.main(["base", "fast", "fast_nohead", "--device", "cpu"])
    assert rows[1]["max_abs_err_vs_base"] <= BF16_REL * rows[1]["base_max_abs"]
    assert rows[2]["max_abs_err_vs_base"] is None  # no base_nohead ran


def test_exp_bwd_floor_table_is_the_perf_bound():
    rows = {r["tower"]: r for r in exp_bwd_floor.table()}
    for tower, n, want_ms in (("vit", 197, 0.3161), ("bert", 133, 0.2134)):
        r = rows[tower]
        assert r["bytes"] == 14 * 500 * n * 768
        assert r["ops"] == 10 * 500 * 12 * n * n * 64
        assert r["floor_ms"] == max(r["bytes"] / 3.35e12, r["ops"] / 989e12) * 1e3
        assert r["bound_by"] == "bytes" and round(r["floor_ms"], 4) == want_ms
    masked = exp_bwd_floor.floor(500, 133, 768, 12, masked=True)
    assert masked["bytes"] == 14 * 500 * 133 * 768 + 4 * 500 * 133


def _tiny_bench_cfg(schema):
    """The bench model's tiny stand-in in `schema`'s classes: one layer a
    tower, 32 wide, at the bench's 224 x 224 images and 133 DNA tokens."""
    cfg = schema.ExperimentConfig()
    cfg.image.vit = schema.ViTConfig(image_size=224, patch_size=32, hidden_size=32,
                                     num_layers=1, num_heads=2, mlp_dim=64)
    cfg.dna.bert = schema.BertConfig(vocab_size=1027, hidden_size=32, num_layers=1,
                                     num_heads=2, intermediate_size=64,
                                     max_position_embeddings=140, with_mlm_head=True)
    return cfg


def _tiny_port_bench_cfg():
    cfg = _tiny_bench_cfg(port_schema)
    cfg.language.enable = False
    cfg.disable_lora = True
    return cfg


def test_exp_prof_runs_its_modes_at_a_tiny_width(monkeypatch):
    monkeypatch.setattr(exp_prof, "flagship_config", _tiny_port_bench_cfg)
    out = exp_prof.run(device="cpu", batch=4)
    assert set(out) == {"both", "image", "dna"}
    assert all(v["ms"] > 0 and v["samples_per_s"] > 0 for v in out.values())


def test_exp_prof_modes_equal_the_jax_scripts(monkeypatch):
    """The JAX script's main at a tiny width (its config, init and timing
    loop patched: each timed call records its output) and the port's `run`
    on the same weights: the same model config at full width, the same
    inputs, and each mode's embeddings within bf16 rounding (2e-2 of the
    largest)."""
    import clibd_tpu.config.schema as jax_schema
    from clibd_tpu.models import init_clibd_params
    from clibd_tpu_torch.models import clibd as port_clibd
    from clibd_tpu_torch.models.convert import model_from_jax
    from clibd_tpu_torch.utils import profiling
    from tests.torch_tiny import numpy_params

    jmod = _script("exp_prof")
    full = jmod.ExperimentConfig()
    full.language.enable, full.disable_lora = False, True
    assert vars_of(exp_prof.flagship_config()) == vars_of(full)

    trees, want = [], []
    monkeypatch.setattr(jmod, "ExperimentConfig", lambda: _tiny_bench_cfg(jax_schema))

    def init(key, cfg):
        trees.append(numpy_params(lambda k: init_clibd_params(k, cfg), 3))
        return trees[-1]

    monkeypatch.setattr(jmod, "init_clibd_params", init)
    monkeypatch.setattr(jmod, "BATCH", 4)
    monkeypatch.setattr(jmod, "timeit", lambda fn, *args, **kw: want.append(fn(*args)) or 1.0)
    monkeypatch.setattr("sys.argv", ["exp_prof", *exp_prof.MODES])
    jmod.main()

    pcfg = _tiny_port_bench_cfg()
    model = model_from_jax(trees[0], pcfg, "cpu")
    got = []
    monkeypatch.setattr(exp_prof, "flagship_config", lambda: pcfg)
    monkeypatch.setattr(port_clibd, "init_clibd_model", lambda cfg, gen, device: model)
    monkeypatch.setattr(profiling, "timeit",
                        lambda fn, device, *a: got.append(fn()) or 1.0)
    exp_prof.run(device="cpu", batch=4)
    (p_img, p_dna), p_image, p_dnaonly = got
    (j_img, j_dna), j_image, j_dnaonly = want
    for mine, theirs, what in ((p_img, j_img, "both/image"), (p_dna, j_dna, "both/dna"),
                               (p_image["image"], j_image, "image"),
                               (p_dnaonly["dna"], j_dnaonly, "dna")):
        _hold(mine, theirs, what)


def vars_of(cfg):
    import dataclasses

    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


@pytest.mark.parametrize("tool,argv", [
    (bench_train, []), (rehearse, []), (exp_bwd_floor, ["measure"]), (exp_prof, []),
    (exp_block, []), (exp_bert, []), (bench_knn, []), (bench_eval, []), (bench_extract, []),
    (soak_train, ["run"]), (soak_extract, ["run"]), (soak_serve, [])])
def test_card_tools_need_a_card(tool, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness would run")
    if tool in (soak_train, soak_extract):
        argv = argv + ["--workdir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tool.main(argv)
