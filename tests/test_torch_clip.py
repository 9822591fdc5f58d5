"""The port's OpenCLIP / BioCLIP backbone (`backbone: open_clip`) against
clibd_tpu: the CLIP towers, `clibd_apply` with BarcodeBERT, the trainable
set, the open_clip state-dict converter and the synthetic CLIP-style text.

One weight set, drawn by the JAX package's init and sharpened with numpy,
feeds both packages through `model_from_jax`.  The JAX side runs with its
flash gate open (`ATTENTION_IMPL=pallas`, the Pallas kernels in interpret
mode), so a key-only attention has the kernel's numerics on both sides; the
text tower's causal attention is eager on both.

Tolerances, each with its reason:
* fp32: FP32_RTOL of the output's scale, plus half the reference's own gap
  between its flash and XLA paths on the same inputs: both packages round P
  (and, with the fused out-projection, the context) to bf16 after fp32
  maths, and a value within float noise of a bf16 boundary may round the
  other way in one of them -- a small part of the whole effect of that
  rounding, which the gap measures;
* bf16: BF16_GAP_FACTOR times the reference's own bf16-vs-fp32 gap on the
  same inputs bounds the difference of the two bf16 implementations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.config.schema import BertConfig, ExperimentConfig
from clibd_tpu.models import clibd as jax_clibd
from clibd_tpu.models import clip as jax_clip
from clibd_tpu.models import layers as jl
from clibd_tpu.models.convert import save_params_npz
from clibd_tpu_torch.config import ExperimentConfig as PortExperimentConfig
from clibd_tpu_torch.data import SyntheticSplit
from clibd_tpu_torch.models import clip as tclip
from clibd_tpu_torch.models import layers as tl
from clibd_tpu_torch.models.clibd import clibd_apply, clip_configs, set_trainable
from clibd_tpu_torch.models.convert import load_params_npz, model_from_jax

FP32_RTOL = 1e-4
P_GAP_FACTOR = 0.5
BF16_GAP_FACTOR = 2.0
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODALITIES = ("image", "dna", "language")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def tiny_clip_cfg(disable_lora=False, cfg_cls=ExperimentConfig):
    cfg = cfg_cls()
    cfg.backbone = "open_clip"
    cfg.disable_lora = disable_lora
    c = cfg.clip
    c.image_size, c.patch_size, c.vision_hidden, c.vision_layers = 32, 16, 128, 2
    c.vision_heads, c.vision_mlp = 2, 256
    c.vocab_size, c.context_length, c.text_hidden, c.text_layers = 300, 16, 128, 2
    c.text_heads, c.text_mlp, c.embed_dim = 2, 256, 64
    cfg.output_dim = 64
    cfg.dna.max_bp = 80  # 1 + 80/5 = 17 tokens
    cfg.dna.bert = type(cfg.dna.bert)(vocab_size=1027, hidden_size=128, num_layers=2, num_heads=2,
                                      intermediate_size=256, max_position_embeddings=40,
                                      with_mlm_head=True)
    return cfg


def _params(tmp_path, cfg, seed=0):
    """JAX init, sharper attention (qkv std 0.1) and non-zero LoRA B, written
    and read back as npz."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_clibd.init_clibd_params(jax.random.PRNGKey(seed), cfg))
    for enc in ("clip_vision", "clip_text", "dna_encoder"):
        blocks = tree[enc]["blocks"]
        blocks["qkv_w"] = (rng.standard_normal(blocks["qkv_w"].shape) * 0.1).astype(np.float32)
        for k in [k for k in tree[enc].get("lora", {}) if k.startswith("b_")]:
            tree[enc]["lora"][k] = (rng.standard_normal(tree[enc]["lora"][k].shape)
                                    * 0.05).astype(np.float32)
    path = str(tmp_path / "params.npz")
    save_params_npz(tree, path)
    return load_params_npz(path)


def _inputs(seed, B=3, ctx=16, vocab=300):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    dna = rng.integers(0, 1027, (B, 17)).astype(np.int32)
    lengths = rng.integers(3, ctx + 1, B)
    ids = rng.integers(1, vocab - 2, (B, ctx)).astype(np.int32)
    ids *= np.arange(ctx)[None] < lengths[:, None]
    ids[:, 0] = vocab - 2
    ids[np.arange(B), lengths - 1] = vocab - 1  # EOT: the row's largest id
    return images, dna, ids


def _compare(monkeypatch, dtype, port_fn, jax_fn):
    """port_fn(torch dtype) / jax_fn(jax dtype) → dicts of outputs, each
    checked by the rules in the module docstring."""
    jd, td = DTYPES[dtype]
    got = port_fn(td)

    def run(impl, jdt):
        monkeypatch.setattr(jl, "ATTENTION_IMPL", impl)
        return jax.jit(lambda: jax_fn(jdt))()

    want = run("pallas", jd)
    other = run("xla", jnp.float32) if dtype == "float32" else run("pallas", jnp.float32)
    for key in got:
        g, w, o = _np(got[key]), _np(want[key]), _np(other[key])
        err = float(np.abs(g - w).max())
        gap = float(np.abs(o - w).max())
        if dtype == "float32":
            bound = FP32_RTOL * float(np.abs(w).max()) + P_GAP_FACTOR * gap
        else:
            bound = BF16_GAP_FACTOR * gap
            assert gap > 0, key
        assert err <= bound, (key, err, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_tower_with_qkv_lora(tmp_path, monkeypatch, dtype):
    cfg = tiny_clip_cfg()
    tree = _params(tmp_path, cfg)
    model = model_from_jax(tree, cfg, "cpu")
    assert set(model.clip_vision.lora.stacked()) == {"a_q", "b_q", "a_v", "b_v", "a_k", "b_k"}
    vcfg, _ = clip_configs(cfg)
    images = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)

    def port(td):
        return {"image": model.clip_vision(torch.from_numpy(images), td)}

    def ref(jd):
        return {"image": jax_clip.clip_vision_apply(tree["clip_vision"], jnp.asarray(images),
                                                     vcfg, jd)}

    _compare(monkeypatch, dtype, port, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_tower_is_causal_and_matches_jax(tmp_path, monkeypatch, dtype):
    cfg = tiny_clip_cfg()
    tree = _params(tmp_path, cfg)
    model = model_from_jax(tree, cfg, "cpu")
    _, tcfg = clip_configs(cfg)
    _, _, ids = _inputs(2)

    def port(td):
        return {"language": model.clip_text(torch.from_numpy(ids), td)}

    def ref(jd):
        return {"language": jax_clip.clip_text_apply(tree["clip_text"], jnp.asarray(ids),
                                                      tcfg, jd)}

    _compare(monkeypatch, dtype, port, ref)
    # causal: tokens after the EOT do not change the pooled feature
    later = ids.copy()
    later[:, -1] = np.where(ids[:, -1] == 0, 7, ids[:, -1])
    with torch.no_grad():
        a = model.clip_text(torch.from_numpy(ids), torch.float32)
        b = model.clip_text(torch.from_numpy(later), torch.float32)
    torch.testing.assert_close(a, b)


@pytest.mark.parametrize("knobs", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clibd_apply_open_clip(tmp_path, monkeypatch, dtype, knobs):
    """Image, DNA and text embeddings of the open_clip backbone; with
    `knobs`, both packages run the fused out-projection and the fused MLP."""
    cfg = tiny_clip_cfg()
    port_cfg = tiny_clip_cfg(cfg_cls=PortExperimentConfig)
    tree = _params(tmp_path, cfg)
    model = model_from_jax(tree, port_cfg, "cpu")
    images, dna, ids = _inputs(3)
    jparams = jax.tree.map(jnp.asarray, tree)
    monkeypatch.setattr(jl, "ATTN_FUSE_OUTPROJ", knobs)
    monkeypatch.setattr(jl, "MLP_IMPL", "pallas" if knobs else "xla")
    monkeypatch.setattr(tl, "ATTN_FUSE_OUTPROJ", knobs)
    monkeypatch.setattr(tl, "MLP_IMPL", "pallas" if knobs else "xla")

    def port(td):
        out = clibd_apply(model, port_cfg, torch.from_numpy(images), torch.from_numpy(dna),
                          {"input_ids": torch.from_numpy(ids)}, compute_dtype=td)
        return {m: out[m] for m in MODALITIES}

    def ref(jd):
        out = jax_clibd.clibd_apply(jparams, cfg, jnp.asarray(images), jnp.asarray(dna),
                                    {"input_ids": jnp.asarray(ids)}, compute_dtype=jd)
        return {m: out[m] for m in MODALITIES}

    _compare(monkeypatch, dtype, port, ref)


@pytest.mark.parametrize("disable_lora,image_freeze,dna_freeze,language_freeze,fix_temp", [
    (True, True, False, True, False),   # the BioCLIP bind-to-image recipe
    (True, False, False, False, True),
    (False, False, False, False, False),
    (False, True, True, False, False),
])
def test_set_trainable_matches_trainable_mask(disable_lora, image_freeze, dna_freeze,
                                              language_freeze, fix_temp):
    cfgs = [tiny_clip_cfg(disable_lora), tiny_clip_cfg(disable_lora, PortExperimentConfig)]
    for c in cfgs:
        c.image.freeze, c.dna.freeze, c.language.freeze = image_freeze, dna_freeze, language_freeze
        c.loss.fix_temperature = fix_temp
    tree = jax.tree.map(np.asarray, jax_clibd.init_clibd_params(jax.random.PRNGKey(0), cfgs[0]))
    mask = jax_clibd.trainable_mask(tree, cfgs[0])
    want = {"/".join(str(getattr(k, "key", k)) for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(mask)[0]}
    model = model_from_jax(tree, cfgs[1], "cpu")
    set_trainable(model, cfgs[1])
    got = {n.replace(".", "/"): p.requires_grad for n, p in model.named_parameters()}
    assert got == want
    assert any(got.values())


def test_clip_params_from_state_dict_matches_jax():
    """An open_clip-named state dict (built as tests/test_clip.py builds
    one) → the same pytrees as the JAX package's converter, which the port's
    CLIP towers then load."""
    from tests.test_clip import build_torch_clip

    vcfg = tclip.CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=24, num_layers=2,
                                  num_heads=3, mlp_dim=48, embed_dim=16)
    tcfg = tclip.CLIPTextConfig(vocab_size=100, context_length=12, hidden_size=16, num_layers=2,
                                num_heads=2, mlp_dim=32, embed_dim=16)
    sd = {k: v.numpy() for k, v in build_torch_clip(vcfg, tcfg).items()}
    got = tclip.clip_params_from_state_dict(sd, vcfg, tcfg)
    want = jax_clip.clip_params_from_state_dict(
        sd, jax_clip.CLIPVisionConfig(**vars(vcfg)), jax_clip.CLIPTextConfig(**vars(tcfg)))
    assert got[2] == pytest.approx(want[2])
    for g_tree, w_tree in zip(got[:2], want[:2]):
        g_flat = jax.tree_util.tree_flatten_with_path(g_tree)[0]
        w_flat = jax.tree_util.tree_flatten_with_path(w_tree)[0]
        assert [p for p, _ in g_flat] == [p for p, _ in w_flat]
        for (path, a), (_, b) in zip(g_flat, w_flat):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    vision = tclip.CLIPVision(vcfg)
    vision.load_state_dict({k.replace("/", "."): torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in _flat(got[0]).items()})
    text = tclip.CLIPText(tcfg)
    text.load_state_dict({k.replace("/", "."): torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in _flat(got[1]).items()})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_clip_normalize_and_causal_mask_match_jax():
    images = np.random.default_rng(4).random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tclip.clip_normalize(torch.from_numpy(images))),
                               _np(jax_clip.clip_normalize(jnp.asarray(images))), rtol=1e-6)
    np.testing.assert_array_equal(_np(tclip.causal_mask_bias(5)),
                                  _np(jax_clip.causal_mask_bias(5)))


def test_synthetic_split_gives_clip_style_text():
    cfg = tiny_clip_cfg(cfg_cls=PortExperimentConfig)
    cfg.batch_size = 4
    batch = next(SyntheticSplit("t", 6, cfg, seed=0).batches())
    ids = batch["language"]["input_ids"]
    assert set(batch["language"]) == {"input_ids"} and ids.shape == (4, 16)
    assert batch["image"].shape == (4, 32, 32, 3)
    assert (ids[:, 0] == 298).all() and (ids.max(axis=1) == 299).all()
    for row in ids:
        eot = int(row.argmax())
        assert (row[1:eot] > 0).all() and (row[1:eot] < 298).all() and not row[eot + 1:].any()


TINY_CLIP_EXP = """
model_output_name: tiny_clip_torch
dataset: bioscan_1m
batch_size: 5
epochs: 1
output_dim: 32
disable_lora: true
load_ckpt: false
default_seed: 42
backbone: open_clip
clip: {image_size: 224, patch_size: 32, vision_hidden: 128, vision_layers: 2, vision_heads: 2,
       vision_mlp: 256, vocab_size: 1000, context_length: 24, text_hidden: 128, text_layers: 2,
       text_heads: 2, text_mlp: 256, embed_dim: 32}
dna:
  bert: {vocab_size: 1027, hidden_size: 128, num_layers: 2, num_heads: 2,
         intermediate_size: 256, max_position_embeddings: 140, with_mlm_head: true}
image: {freeze: true}
language: {freeze: true}
loss: {bind_to: image}
"""


def test_cli_eval_and_train_run_the_open_clip_backbone(tiny_hdf5, tmp_path):
    """`python -m clibd_tpu_torch.cli eval` and `train` on the fixture with
    `backbone: open_clip` and both opt-in kernels on through the environment
    (their plain versions on the CPU): the grid prints, training writes
    best/ with the CLIP towers and keeps the frozen towers as they were."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    exp = tmp_path / "tiny_clip.yaml"
    exp.write_text(TINY_CLIP_EXP)
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CLIBD_ATTN_FUSE_OUTPROJ="1", CLIBD_MLP_IMPL="pallas")
    common = ["-e", str(exp), "--device", "cpu", "--hdf5", tiny_hdf5]
    proc = subprocess.run(
        [sys.executable, "-m", "clibd_tpu_torch.cli", "eval", *common, "pipeline.num_workers=0",
         "project_root_path=" + str(tmp_path), "inference_and_eval_setting.plot_embeddings=false"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Seen Order" in proc.stdout
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "clibd_tpu_torch.cli", "train", *common, "--output-dir", str(out),
         "pipeline.num_workers=0", "pipeline.use_native_decoder=false"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert np.isfinite(json.loads(proc.stdout.strip().splitlines()[-1])["final_loss"])
    tree = load_params_npz(str(out / "best" / "params.npz"))
    assert tree["clip_vision"]["blocks"]["out_w"].shape == (2, 128, 128)
    assert tree["clip_text"]["token_embedding"].shape == (1000, 128)
