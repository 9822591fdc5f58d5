"""clibd_tpu_torch's layers, encoders and clibd_apply against clibd_tpu.

One weight set, drawn with numpy and written with clibd_tpu's npz writer,
feeds both packages: the port reads it back with its own `load_params_npz`
and maps it onto its modules with `params_from_jax`.

Attention: the port always takes the kernel's numerics for a key-only mask
(fp32 scores, bf16 P).  The JAX side runs with `layers.ATTENTION_IMPL`
patched to "pallas" (the Pallas kernel in interpret mode, the same numerics)
and to "xla" (bf16 scores in bf16 mode, fp32 P in fp32 mode).

Tolerances, each with its reason:
* fp32 against "pallas": both sides round P and V to bf16 after fp32 maths,
  so they agree to float noise (FP32_RTOL relative to the output's scale),
  except where a probability lies within float noise of a bf16 rounding
  boundary and rounds the other way in one package.  Such flips are a small
  part of the whole effect of rounding P, which the reference's own
  kernel-vs-xla gap on the same inputs measures: half that gap bounds them.
  One layer agrees to ~1e-6; a whole encoder shows a flip or two;
* fp32 against "xla": the port rounds P and the reference does not, so 2x
  the reference's own kernel-vs-xla gap bounds the port;
* bf16: the reference's own bf16-vs-fp32 gap on the same inputs bounds the
  difference of the two bf16 implementations (BF16_GAP_FACTOR x that gap).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.config.schema import BertConfig, ExperimentConfig, ViTConfig
from clibd_tpu.models import bert as jax_bert
from clibd_tpu.models import clibd as jax_clibd
from clibd_tpu.models import layers as jl
from clibd_tpu.models import lora as jax_lora
from clibd_tpu.models import vit as jax_vit
from clibd_tpu.models.convert import save_params_npz
from clibd_tpu_torch.models import layers as tl
from clibd_tpu_torch.models.clibd import clibd_apply
from clibd_tpu_torch.models.convert import load_params_npz, model_from_jax
from clibd_tpu_torch.models.lora import Lora, merge_lora_into_qkv

FP32_RTOL = 1e-4
# fp32: share of the reference's own kernel-vs-xla gap (the whole effect of
# rounding P to bf16) allowed on top of FP32_RTOL
P_GAP_FACTOR = {"pallas": 0.5, "xla": 2.0}
BF16_GAP_FACTOR = 2.0
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _t(tree):
    """numpy pytree → torch tensors (ints stay ints)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _roundtrip(tmp_path, tree):
    path = str(tmp_path / "params.npz")
    save_params_npz(tree, path)
    return load_params_npz(path)


def _scale_of(a):
    return float(np.abs(a).max())


def _check_fp32(got, want, p_gap, impl):
    got, want = _np(got), _np(want)
    err = float(np.abs(got - want).max())
    bound = FP32_RTOL * _scale_of(want) + P_GAP_FACTOR[impl] * p_gap
    assert err <= bound, (err, bound)


def _check_bf16(got, jax_bf16, jax_fp32):
    gap = float(np.abs(_np(jax_bf16) - _np(jax_fp32)).max())
    err = float(np.abs(_np(got) - _np(jax_bf16)).max())
    assert 0 < gap and err <= BF16_GAP_FACTOR * gap, (err, gap)


def _run_jax(monkeypatch, impl, fn):
    """fn under the given attention impl, jitted (interpret-mode Pallas runs
    much faster compiled than op by op)."""
    monkeypatch.setattr(jl, "ATTENTION_IMPL", impl)
    return jax.jit(fn)()


def _compare(monkeypatch, impl, dtype, port_fn, jax_fn):
    """port_fn(torch_dtype) / jax_fn(jax_dtype) → an output or a dict of
    outputs; each is checked by the rules above."""
    jd, td = DTYPES[dtype]
    got = port_fn(td)
    if dtype == "float32":
        want = _run_jax(monkeypatch, impl, lambda: jax_fn(jnp.float32))
        other = _run_jax(monkeypatch, "xla" if impl == "pallas" else "pallas",
                         lambda: jax_fn(jnp.float32))
    else:
        want = _run_jax(monkeypatch, impl, lambda: jax_fn(jnp.bfloat16))
        want32 = _run_jax(monkeypatch, impl, lambda: jax_fn(jnp.float32))
    for key in (got if isinstance(got, dict) else [None]):
        pick = (lambda o: o) if key is None else (lambda o: o[key])
        if dtype == "float32":
            gap = float(np.abs(_np(pick(other)) - _np(pick(want))).max())
            _check_fp32(pick(got), pick(want), gap, impl)
        else:
            _check_bf16(pick(got), pick(want), pick(want32))


# ---------------------------------------------------------------------------
# stateless layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fast", [False, True])
def test_layernorm(rng, fast):
    x = rng.standard_normal((3, 7, 128)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(128).astype(np.float32)
    bias = rng.standard_normal(128).astype(np.float32)
    dt_j, dt_t = (jnp.bfloat16, torch.bfloat16) if fast else (jnp.float32, torch.float32)
    want = jl.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                        jnp.asarray(x).astype(dt_j), 1e-12, fast=fast)
    got = tl.layernorm(torch.from_numpy(x).to(dt_t), torch.from_numpy(scale),
                       torch.from_numpy(bias), 1e-12, fast=fast)
    assert got.dtype == dt_t
    if fast:  # bf16 outputs: one bf16 ulp of |y| (< 16 here)
        np.testing.assert_allclose(_np(got), _np(want), atol=2 ** -7 * 16)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
def test_gelu(rng, fast):
    x = rng.standard_normal((4, 64)).astype(np.float32) * 3
    np.testing.assert_allclose(_np(tl.gelu(torch.from_numpy(x), fast=fast)),
                               _np(jl.gelu(jnp.asarray(x), fast=fast)), rtol=1e-5, atol=1e-6)


def test_quick_gelu_and_mask_bias(rng):
    x = rng.standard_normal((4, 64)).astype(np.float32)
    np.testing.assert_allclose(_np(tl.quick_gelu(torch.from_numpy(x))),
                               _np(jl.quick_gelu(jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    att = (rng.random((3, 9)) > 0.4).astype(np.int32)
    np.testing.assert_array_equal(_np(tl.attention_mask_bias(torch.from_numpy(att))),
                                  _np(jl.attention_mask_bias(jnp.asarray(att))))


# ---------------------------------------------------------------------------
# attention and the stacked blocks
# ---------------------------------------------------------------------------

D, H, MLP, L, R = 128, 2, 256, 2, 4


def _block_tree(rng, lora=True):
    def n(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    tree = {"blocks": {
        "qkv_w": n(L, D, 3 * D), "qkv_b": n(L, 3 * D), "out_w": n(L, D, D), "out_b": n(L, D),
        "fc1_w": n(L, D, MLP), "fc1_b": n(L, MLP), "fc2_w": n(L, MLP, D), "fc2_b": n(L, D),
        "ln1_scale": 1 + n(L, D), "ln1_bias": n(L, D), "ln2_scale": 1 + n(L, D),
        "ln2_bias": n(L, D)}}
    if lora:
        tree["lora"] = {"a_q": n(L, D, R), "b_q": n(L, R, D), "a_v": n(L, D, R),
                        "b_v": n(L, R, D)}
    return tree


def _mask(rng, B, N):
    att = (rng.random((B, N)) > 0.3).astype(np.int32)
    att[:, 0] = 1
    return att


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_fused_qkv_attention_lora_and_mask(rng, tmp_path, monkeypatch, impl, dtype):
    tree = _roundtrip(tmp_path, _block_tree(rng))
    p = {k: v[0] for k, v in tree["blocks"].items()}
    lo = {k: v[0] for k, v in tree["lora"].items()}
    x = rng.standard_normal((2, 20, D)).astype(np.float32)
    att = _mask(rng, 2, 20)
    tp, tlo = _t(p), _t(lo)

    def port(td):
        return tl.fused_qkv_attention(
            torch.from_numpy(x), tp["qkv_w"], tp["qkv_b"], tp["out_w"], tp["out_b"], H,
            mask_bias=tl.attention_mask_bias(torch.from_numpy(att)), lora=tlo,
            compute_dtype=td)

    def ref(jd):
        return jl.fused_qkv_attention(
            jnp.asarray(x), p["qkv_w"], p["qkv_b"], p["out_w"], p["out_b"], H,
            mask_bias=jl.attention_mask_bias(jnp.asarray(att)),
            lora={k: jnp.asarray(v) for k, v in lo.items()}, compute_dtype=jd)

    _compare(monkeypatch, impl, dtype, port, ref)


def test_query_dependent_mask_takes_the_eager_path(rng, monkeypatch):
    """A causal [1, 1, N, N] bias cannot go to the kernel; both packages run
    their eager path with scores in compute_dtype (fp32 here: tight)."""
    p = {k: v[0] for k, v in _block_tree(rng, lora=False)["blocks"].items()}
    x = rng.standard_normal((2, 13, D)).astype(np.float32)
    causal = np.triu(np.full((13, 13), np.finfo(np.float32).min, np.float32), 1)[None, None]
    tp = _t(p)
    got = tl.fused_qkv_attention(torch.from_numpy(x), tp["qkv_w"], tp["qkv_b"], tp["out_w"],
                                 tp["out_b"], H, mask_bias=torch.from_numpy(causal),
                                 compute_dtype=torch.float32)
    monkeypatch.setattr(jl, "ATTENTION_IMPL", "xla")
    want = jl.fused_qkv_attention(jnp.asarray(x), p["qkv_w"], p["qkv_b"], p["out_w"],
                                  p["out_b"], H, mask_bias=jnp.asarray(causal),
                                  compute_dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_transformer_stack(rng, tmp_path, monkeypatch, pre_ln, dtype):
    tree = _roundtrip(tmp_path, _block_tree(rng))
    x = rng.standard_normal((2, 17, D)).astype(np.float32)
    att = _mask(rng, 2, 17)
    stack = tl.TransformerStack(L, D, MLP)
    stack.load_state_dict({k: torch.from_numpy(v) for k, v in tree["blocks"].items()})
    lora_mod = Lora(L, D, R)
    lora_mod.load_state_dict({k: torch.from_numpy(v) for k, v in tree["lora"].items()})

    def port(td):
        return stack(torch.from_numpy(x).to(td), num_heads=H, pre_ln=pre_ln, ln_eps=1e-6,
                     mask_bias=tl.attention_mask_bias(torch.from_numpy(att)), lora=lora_mod,
                     compute_dtype=td)

    def ref(jd):
        return jl.transformer_stack(
            {k: jnp.asarray(v) for k, v in tree["blocks"].items()}, jnp.asarray(x).astype(jd),
            num_heads=H, pre_ln=pre_ln, ln_eps=1e-6,
            mask_bias=jl.attention_mask_bias(jnp.asarray(att)),
            lora={k: jnp.asarray(v) for k, v in tree["lora"].items()}, compute_dtype=jd)

    _compare(monkeypatch, "pallas", dtype, port, ref)


def test_merge_lora_into_qkv(rng):
    tree = _block_tree(rng)
    got = merge_lora_into_qkv(_t(tree["blocks"]), _t(tree["lora"]))["qkv_w"]
    want = jax_lora.merge_lora_into_qkv(jax.tree.map(jnp.asarray, tree["blocks"]),
                                        jax.tree.map(jnp.asarray, tree["lora"]))["qkv_w"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# encoders and the tri-modal model, through the npz → params_from_jax bridge
# ---------------------------------------------------------------------------


def tiny_cfg(disable_lora=False):
    cfg = ExperimentConfig()
    cfg.disable_lora = disable_lora
    cfg.image.vit = ViTConfig(image_size=32, patch_size=16, hidden_size=D, num_layers=L,
                              num_heads=H, mlp_dim=MLP)
    cfg.dna.max_bp = 80  # 1 + 80/5 = 17 tokens
    cfg.dna.bert = BertConfig(vocab_size=1027, hidden_size=D, num_layers=L, num_heads=H,
                              intermediate_size=MLP, max_position_embeddings=40,
                              with_mlm_head=True)
    cfg.language.bert = BertConfig(vocab_size=300, hidden_size=D, num_layers=L, num_heads=H,
                                   intermediate_size=MLP, max_position_embeddings=24)
    cfg.output_dim = 64
    return cfg


def _params(rng, tmp_path, cfg):
    """JAX init, then sharper attention (qkv std 0.1) and non-zero LoRA B,
    written and read back as npz."""
    tree = jax.tree.map(np.asarray, jax_clibd.init_clibd_params(jax.random.PRNGKey(0), cfg))
    for enc in ("image_encoder", "dna_encoder", "language_encoder"):
        blocks = tree[enc]["blocks"]
        blocks["qkv_w"] = (rng.standard_normal(blocks["qkv_w"].shape) * 0.1).astype(np.float32)
        if "lora" in tree[enc]:
            for k in ("b_q", "b_v"):
                tree[enc]["lora"][k] = (rng.standard_normal(tree[enc]["lora"][k].shape)
                                        * 0.05).astype(np.float32)
    return _roundtrip(tmp_path, tree)


def _inputs(rng, B=3):
    images = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    dna = rng.integers(0, 1027, (B, 17)).astype(np.int32)
    ids = rng.integers(0, 300, (B, 20)).astype(np.int32)
    att = _mask(rng, B, 20)
    return images, dna, {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                         "attention_mask": att}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_apply(rng, tmp_path, monkeypatch, dtype):
    cfg = tiny_cfg()
    tree = _params(rng, tmp_path, cfg)
    model = model_from_jax(tree, cfg, "cpu")
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)

    def port(td):
        return model.image_encoder(torch.from_numpy(images), compute_dtype=td)

    def ref(jd):
        return jax_vit.vit_apply(tree["image_encoder"], jnp.asarray(images), cfg.image.vit,
                                 compute_dtype=jd)

    _compare(monkeypatch, "pallas", dtype, port, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_encode_with_mlm_head(rng, tmp_path, monkeypatch, dtype):
    cfg = tiny_cfg()
    tree = _params(rng, tmp_path, cfg)
    model = model_from_jax(tree, cfg, "cpu")
    dna = rng.integers(0, 1027, (3, 17)).astype(np.int32)
    att = _mask(rng, 3, 17)
    enc = model.dna_encoder

    def port(td):
        hidden = enc(torch.from_numpy(dna), attention_mask=torch.from_numpy(att),
                     compute_dtype=td)
        return enc.mlm_head_apply(hidden, td)

    def ref(jd):
        p = tree["dna_encoder"]
        hidden = jax_bert.bert_encode(p, jnp.asarray(dna), cfg.dna.bert,
                                      attention_mask=jnp.asarray(att), compute_dtype=jd)
        return jax_bert.mlm_head_apply(p, hidden, cfg.dna.bert, jd)

    _compare(monkeypatch, "pallas", dtype, port, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_clibd_apply_trimodal(rng, tmp_path, monkeypatch, impl, dtype):
    cfg = tiny_cfg()
    tree = _params(rng, tmp_path, cfg)
    model = model_from_jax(tree, cfg, "cpu")
    images, dna, lang = _inputs(rng)
    jparams = jax.tree.map(jnp.asarray, tree)

    modalities = ("image", "dna", "language")

    def port(td):
        out = clibd_apply(model, cfg, torch.from_numpy(images), torch.from_numpy(dna),
                          _t(lang), compute_dtype=td)
        return {m: out[m] for m in modalities}

    def ref(jd):
        out = jax_clibd.clibd_apply(jparams, cfg, jnp.asarray(images), jnp.asarray(dna),
                                    {k: jnp.asarray(v) for k, v in lang.items()},
                                    compute_dtype=jd)
        return {m: out[m] for m in modalities}

    _compare(monkeypatch, impl, dtype, port, ref)
    out = clibd_apply(model, cfg, torch.from_numpy(images), None, None)
    assert out["dna"] is None and out["language"] is None
    np.testing.assert_allclose(float(out["logit_scale"]), 1 / 0.07, rtol=1e-6)


OVERLAP = ("for_bioscan_5m/barcodeBERT_trained_with_5m/"
           "image_dna_text_seed_42_new_barcodeBERT_5M.yaml")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overlap_dna_tower_matches_jax(tmp_path, monkeypatch, dtype):
    """The overlap-tokenizer config's DNA tower (k=4, stride 1: 657 tokens
    with a key mask, the softmax_mean readout), cut to 2 layers and 2 heads
    (D=128), through the port's encode_dna against clibd_tpu's on the same
    weights and barcodes (one 660 bp, one 430 bp, so one padded row)."""
    from clibd_tpu.config import load_config
    from clibd_tpu_torch.data.tokenizers import tokenize_dna_batch_overlapping
    from clibd_tpu_torch.models.clibd import encode_dna

    cfg = load_config(experiment=OVERLAP).model_config
    cfg.image.enable = cfg.language.enable = False
    full = cfg.dna.bert
    cfg.dna.bert = BertConfig(vocab_size=full.vocab_size, hidden_size=128, num_layers=2,
                              num_heads=2, intermediate_size=256,
                              max_position_embeddings=full.max_position_embeddings,
                              with_mlm_head=True)
    rng = np.random.default_rng(657)
    tree = jax.tree.map(np.asarray, jax_clibd.init_clibd_params(jax.random.PRNGKey(0), cfg))
    blocks = tree["dna_encoder"]["blocks"]
    blocks["qkv_w"] = (rng.standard_normal(blocks["qkv_w"].shape) * 0.1).astype(np.float32)
    tree = _roundtrip(tmp_path, tree)
    model = model_from_jax(tree, cfg, "cpu")
    bases = np.frombuffer(b"ACGT", np.uint8)
    barcodes = [bases[rng.integers(0, 4, n)].tobytes() for n in (660, 430)]
    ids, att = tokenize_dna_batch_overlapping(barcodes, k=cfg.dna.kmer, stride=cfg.dna.stride,
                                              max_bp=cfg.dna.max_bp)
    tokens = {"input_ids": ids, "attention_mask": att[:, :ids.shape[1]]}
    assert ids.shape == (2, 657) and tokens["attention_mask"][1].sum() == 430
    jparams = jax.tree.map(jnp.asarray, tree)

    def port(td):
        return encode_dna(model, cfg, _t(tokens), compute_dtype=td)

    def ref(jd):
        return jax_clibd.encode_dna(jparams, cfg, {k: jnp.asarray(v) for k, v in tokens.items()},
                                    compute_dtype=jd)

    _compare(monkeypatch, "pallas", dtype, port, ref)


def test_bridge_is_strict_about_the_config(rng, tmp_path):
    """LoRA params in the npz but disable_lora in the config: refuse."""
    cfg = tiny_cfg()
    tree = _params(rng, tmp_path, cfg)
    with pytest.raises(RuntimeError, match="lora"):
        model_from_jax(tree, tiny_cfg(disable_lora=True), "cpu")
