"""The port's torch-checkpoint importers (`clibd_tpu_torch.models.convert`,
`engine.checkpoint.load_params_any` / `load_model_any`,
`cli.common._resolve_params`) against clibd_tpu's on the same files.

Every checkpoint is written in-process from a generator seeded in the test:
`chip_smoke.draw_port_params` draws the port's parameters and
`chip_smoke.reference_state_dict` lays them out in the reference's names
and layouts (the writer the card's phase 13 uses), or `transformers` builds
an HF BERT from a config.  Both packages read the same file.

Tolerances: the pytrees are bit-identical (both importers are the same
numpy code).  Embeddings (fp32, unit-norm) agree to EMB_ATOL: the JAX side
runs its Pallas attention in interpret mode, the port the kernel's plain
version, both rounding P to bf16 after fp32 maths, so the two differ by
float noise (~1e-7 here) unless a probability rounds the other way.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from clibd_tpu.config.schema import BertConfig, ExperimentConfig, ViTConfig
from clibd_tpu.engine.checkpoint import load_params_any as jax_load_params_any
from clibd_tpu.models import clibd as jax_clibd
from clibd_tpu.models import convert as jax_convert
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.models import vit as jax_vit
from clibd_tpu_torch.engine.checkpoint import load_model_any, load_params_any
from clibd_tpu_torch.models import convert as port_convert
from clibd_tpu_torch.models.clibd import clibd_apply, set_trainable
from clibd_tpu_torch.models.vit import ViT

REPO = Path(__file__).resolve().parents[1]
EMB_ATOL = 1e-4
MODALITIES = ("image", "dna", "language")


def tiny_cfg(lora: bool = False) -> ExperimentConfig:
    cfg = ExperimentConfig()
    cfg.amp = False
    cfg.image.vit = ViTConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=2,
                              num_heads=2, mlp_dim=128)
    cfg.dna.max_bp = 80  # 1 + 80/5 = 17 tokens
    cfg.dna.bert = BertConfig(vocab_size=1027, hidden_size=64, num_layers=2, num_heads=2,
                              intermediate_size=128, max_position_embeddings=40,
                              with_mlm_head=True)
    cfg.language.bert = BertConfig(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
                                   intermediate_size=256, max_position_embeddings=24)
    cfg.output_dim = 64
    cfg.disable_lora = not lora
    cfg.lora_rank = 4
    return cfg


def batch(cfg, seed: int, n: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    size = cfg.image.vit.image_size
    lengths = rng.integers(3, 21, n)
    att = (np.arange(20)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, cfg.language.bert.vocab_size, (n, 20)).astype(np.int32) * att
    return {"image": rng.random((n, size, size, 3), dtype=np.float32),
            "dna": rng.integers(0, cfg.dna.bert.vocab_size, (n, 17)).astype(np.int32),
            "language": {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                         "attention_mask": att}}


def assert_pytrees_identical(got: dict, want: dict) -> None:
    got, want = port_convert.flatten_pytree(got), jax_convert.flatten_pytree(want)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


def embeddings(tree_or_model, cfg, b):
    """(JAX package, port) fp32 embeddings of batch `b`."""
    saved = jax_layers.ATTENTION_IMPL
    jax_layers.ATTENTION_IMPL = "pallas"  # the Pallas kernel in interpret mode
    try:
        tree, model = tree_or_model
        j = jax_clibd.clibd_apply(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(b["image"]),
                                  jnp.asarray(b["dna"]),
                                  {k: jnp.asarray(v) for k, v in b["language"].items()},
                                  compute_dtype=jnp.float32)
    finally:
        jax_layers.ATTENTION_IMPL = saved
    with torch.no_grad():
        p = clibd_apply(model, cfg, torch.from_numpy(b["image"]), torch.from_numpy(b["dna"]),
                        {k: torch.from_numpy(v) for k, v in b["language"].items()},
                        compute_dtype=torch.float32)
    return j, p


# (LoRA recipe, LoRA checkpoint, legacy names, stored dtype, padded vocabulary,
# where the MLM decoder's bias sits)
LAYOUTS = {
    "plain": (False, False, False, torch.float32, 0, "decoder.bias"),
    "plain_bf16": (False, False, False, torch.bfloat16, 0, "decoder.bias"),
    "lora_legacy": (True, True, True, torch.float32, 3, "bias"),
    "plain_under_lora_recipe": (True, False, False, torch.float32, 2, "decoder.bias"),
}


def write_checkpoint(path, layout: str, seed: int):
    """→ (cfg, the writer's port-layout parameters) after writing `path`."""
    lora_recipe, lora_ckpt, legacy, dtype, vocab_extra, bias_at = LAYOUTS[layout]
    gen = torch.Generator().manual_seed(seed)
    params = chip_smoke.draw_port_params(tiny_cfg(lora_ckpt), gen)
    if lora_ckpt:  # adapters that change the output (a fresh B is zero)
        for k in [k for k in params if ".lora.b_" in k]:
            params[k] = torch.randn(params[k].shape, generator=gen) * 0.2
    sd = chip_smoke.reference_state_dict(params, legacy=legacy, vocab_extra=vocab_extra,
                                         decoder_bias_at=bias_at, generator=gen)
    torch.save({k: v.to(dtype) for k, v in sd.items()}, path)
    return tiny_cfg(lora_recipe), {k: v.to(dtype).float() for k, v in params.items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reference_checkpoint_pytree_matches_jax(tmp_path, layout):
    """A released best.pth in each layout: the port's pytree is the JAX
    package's bit for bit, and the module holds the writer's tensors under
    the inverse layout (the adapters only where the checkpoint has them)."""
    path = str(tmp_path / "best.pth")
    cfg, params = write_checkpoint(path, layout, seed=3)
    assert_pytrees_identical(load_params_any(path, cfg), jax_load_params_any(path, cfg))
    model = load_model_any(path, cfg, "cpu")
    got = dict(model.named_parameters())
    assert set(got) == set(params)
    for name, p in got.items():
        assert torch.equal(p, params[name]), name
    has_lora = LAYOUTS[layout][1]
    for tower in (model.image_encoder, model.dna_encoder, model.language_encoder):
        assert (tower.lora is not None) == has_lora
    assert got["logit_scale"].shape == ()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reference_checkpoint_embeddings_match_jax(tmp_path, layout):
    """clibd_apply of both packages on the imported weights (a LoRA recipe fed
    a plain checkpoint runs without adapters in both), and the trainable
    sets of `set_trainable` and `trainable_mask`."""
    path = str(tmp_path / "best.pth")
    cfg, _ = write_checkpoint(path, layout, seed=4)
    tree = jax_load_params_any(path, cfg)
    model = load_model_any(path, cfg, "cpu")
    j, p = embeddings((tree, model), cfg, batch(cfg, seed=5))
    for m in MODALITIES:
        err = float(np.abs(np.asarray(j[m]) - p[m].numpy()).max())
        assert err <= EMB_ATOL, (m, err)
    mask = jax_convert.flatten_pytree(jax_clibd.trainable_mask(tree, cfg))
    trainable = {n.replace(".", "/") for n, q in set_trainable(model, cfg).named_parameters()
                 if q.requires_grad}
    assert trainable == {k for k, v in mask.items() if bool(v)}


@pytest.mark.parametrize("with_head", [True, False])
def test_timm_vit_state_dict(with_head):
    """A timm ViT state dict, with and without `head.*` (then a zero head of
    output_dim): bit-identical pytrees, and the port's ViT on it against
    `vit_apply`."""
    cfg = tiny_cfg()
    gen = torch.Generator().manual_seed(6)
    vit = chip_smoke._sub(chip_smoke.draw_port_params(cfg, gen), "image_encoder.")
    sd = {k: v.numpy() for k, v in chip_smoke.vit_state_dict(vit).items()
          if with_head or not k.startswith("head.")}
    want = jax_convert.vit_params_from_timm_state_dict(sd, cfg.image.vit, output_dim=48)
    got = port_convert.vit_params_from_timm_state_dict(sd, cfg.image.vit, output_dim=48)
    assert_pytrees_identical(got, want)
    if not with_head:
        assert got["head"]["w"].shape == (64, 48) and not got["head"]["w"].any()
    else:
        np.testing.assert_array_equal(got["head"]["w"], vit["head.w"].numpy())
    model = ViT(cfg.image.vit, output_dim=got["head"]["w"].shape[1])
    model.load_state_dict(port_convert.params_from_jax(got), strict=True)
    x = np.random.default_rng(7).random((3, 32, 32, 3), dtype=np.float32)
    saved = jax_layers.ATTENTION_IMPL
    jax_layers.ATTENTION_IMPL = "pallas"
    try:
        ref = jax_vit.vit_apply(jax.tree.map(jnp.asarray, want), jnp.asarray(x), cfg.image.vit,
                                compute_dtype=jnp.float32)
    finally:
        jax_layers.ATTENTION_IMPL = saved
    with torch.no_grad():
        out = model(torch.from_numpy(x), compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=EMB_ATOL * float(np.abs(ref).max()))


def hf_bert(cfg: BertConfig, mlm: bool, seed: int):
    """A transformers BERT from a config, its vocabulary padded past the
    config's (the importer cuts it)."""
    from transformers import BertConfig as HFBertConfig
    from transformers import BertForMaskedLM, BertModel

    hfc = HFBertConfig(vocab_size=cfg.vocab_size + 5, hidden_size=cfg.hidden_size,
                       num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
                       intermediate_size=cfg.intermediate_size,
                       max_position_embeddings=cfg.max_position_embeddings,
                       type_vocab_size=cfg.type_vocab_size)
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return (BertForMaskedLM if mlm else BertModel)(hfc).eval(), hfc


@pytest.mark.parametrize("mlm", [False, True], ids=["BertModel", "BertForMaskedLM"])
def test_hf_bert_state_dict(mlm):
    cfg = tiny_cfg().dna.bert if mlm else tiny_cfg().language.bert
    hf, _ = hf_bert(cfg, mlm, seed=8)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    kw = dict(prefix="bert.", mlm_head_prefix="cls.predictions.") if mlm else {}
    got = port_convert.bert_params_from_hf_state_dict(sd, cfg, **kw)
    assert_pytrees_identical(got, jax_convert.bert_params_from_hf_state_dict(sd, cfg, **kw))
    assert got["embeddings"]["word"].shape == (cfg.vocab_size, cfg.hidden_size)
    assert ("mlm_head" in got) == mlm


def test_raw_barcode_bert_checkpoint(tmp_path):
    """{"model": state dict with "module.", "bert_config": {...}}: the same
    BertConfig and a bit-identical pytree from both packages."""
    cfg = tiny_cfg().dna.bert
    hf, hfc = hf_bert(cfg, True, seed=9)
    path = str(tmp_path / "barcode_bert.pth")
    torch.save({"model": {"module." + k: v for k, v in hf.state_dict().items()},
                "bert_config": {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                                "num_hidden_layers": cfg.num_layers,
                                "num_attention_heads": cfg.num_heads,
                                "intermediate_size": cfg.intermediate_size,
                                "max_position_embeddings": cfg.max_position_embeddings}}, path)
    got, got_cfg = port_convert.load_barcode_bert_checkpoint(path)
    want, want_cfg = jax_convert.load_barcode_bert_checkpoint(path)
    assert vars(got_cfg) == vars(want_cfg)
    assert_pytrees_identical(got, want)


def test_missing_tower_raises(tmp_path):
    """A tower the config enables but the checkpoint lacks: the error names
    the tower's missing keys."""
    path = str(tmp_path / "best.pth")
    cfg = tiny_cfg()
    params = chip_smoke.draw_port_params(cfg, torch.Generator().manual_seed(10))
    sd = chip_smoke.reference_state_dict({k: v for k, v in params.items()
                                          if not k.startswith("language_")})
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match=r"language_encoder.*language_encoder\.blocks"):
        load_model_any(path, cfg, "cpu")


TINY_EXP = """
model_output_name: tiny_torch
dataset: bioscan_1m
batch_size: 5
epochs: 1
output_dim: 32
disable_lora: true
default_seed: 42
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 64, num_layers: 2, num_heads: 2,
        mlp_dim: 128}
dna:
  bert: {vocab_size: 1027, hidden_size: 64, num_layers: 2, num_heads: 2,
         intermediate_size: 128, max_position_embeddings: 140, with_mlm_head: true}
language:
  bert: {vocab_size: 1000, hidden_size: 64, num_layers: 2, num_heads: 2,
         intermediate_size: 128, max_position_embeddings: 24}
"""


def test_resolve_params_and_cli_eval_load_a_pth(tiny_hdf5, tmp_path):
    """`_resolve_params` with model_config.ckpt_path set to a best.pth loads
    it on the CPU, and `eval --device cpu model_config.ckpt_path=...` runs a
    released checkpoint end to end."""
    from clibd_tpu_torch.cli.common import _resolve_params
    from clibd_tpu_torch.config import load_config

    exp = tmp_path / "tiny.yaml"
    exp.write_text(TINY_EXP)
    path = str(tmp_path / "best.pth")
    gcfg = load_config(experiment=str(exp), overrides=[f"model_config.ckpt_path={path}"])
    params = chip_smoke.draw_port_params(gcfg.model_config, torch.Generator().manual_seed(11))
    torch.save(chip_smoke.reference_state_dict(params), path)
    model = _resolve_params(gcfg, torch.device("cpu"))
    for name, p in model.named_parameters():
        assert p.device.type == "cpu" and torch.equal(p, params[name]), name

    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "clibd_tpu_torch.cli", "eval", "-e", str(exp), "--device", "cpu",
         "--hdf5", tiny_hdf5, f"model_config.ckpt_path={path}",
         "project_root_path=" + str(tmp_path), "pipeline.num_workers=0",
         "inference_and_eval_setting.plot_embeddings=false"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"Loading checkpoint: {path}" in proc.stdout and "Imported" in proc.stdout
    assert "Seen Order" in proc.stdout and "fresh init" not in proc.stdout
