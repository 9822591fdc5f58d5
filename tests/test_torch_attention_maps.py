"""The attention-rollout probe of the port (`analysis/attention_maps.py`)
against clibd_tpu's on the CPU: one seeded weight set (in the JAX
package's layout, bridged by `models/convert.py`) through both packages'
probes in fp32 -- the pre-LN ViT, the post-LN BERT with and without its
key mask, each with and without LoRA adapters -- within 1e-5; the rollout
on identical probabilities bit for bit; and `attention-maps --modality both --device
cpu` on the HDF5 fixture against the JAX package's command, the masks at
cosine >= 0.999."""

import numpy as np
import pytest
import torch

import jax

from clibd_tpu.analysis import attention_maps as jax_am
from clibd_tpu.cli import main as jax_main
from clibd_tpu.config import load_config as jax_load_config
from clibd_tpu.config.schema import BertConfig, ViTConfig
from clibd_tpu.models import init_clibd_params
from clibd_tpu.models.bert import init_bert_params
from clibd_tpu.models.convert import save_params_npz
from clibd_tpu.models.vit import init_vit_params
from clibd_tpu_torch import cli as port_cli
from clibd_tpu_torch.analysis import attention_maps as port_am
from clibd_tpu_torch.config import schema as port_schema
from clibd_tpu_torch.models.bert import Bert
from clibd_tpu_torch.models.convert import params_from_jax
from clibd_tpu_torch.models.vit import ViT
from tests.torch_tiny import numpy_params

PROBS_ATOL = 1e-5
MASK_COSINE_MIN = 0.999
LORA_RANK = 4

VIT = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=3, num_heads=4, mlp_dim=64)
BERT = dict(vocab_size=60, hidden_size=32, num_layers=3, num_heads=4, intermediate_size=64,
            max_position_embeddings=24)

ATTN_EXP = """
model_output_name: tiny_attention_maps
dataset: bioscan_1m
batch_size: 4
output_dim: 16
amp: false
disable_lora: true
default_seed: 42
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 32, num_layers: 3, num_heads: 4,
        mlp_dim: 64}
dna:
  bert: {vocab_size: 1027, hidden_size: 32, num_layers: 3, num_heads: 4, intermediate_size: 64,
         max_position_embeddings: 140, with_mlm_head: true}
language:
  bert: {vocab_size: 2000, hidden_size: 16, num_layers: 1, num_heads: 2, intermediate_size: 32,
         max_position_embeddings: 24}
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, its module fixtures included: the
    suite runs six files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharpen(tree, seed):
    """Attention that is not near uniform: larger q/k/v weights, and LoRA
    B matrices that are not zero (a fresh adapter leaves the output as it
    is)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, tree)
    w = tree["blocks"]["qkv_w"]
    tree["blocks"]["qkv_w"] = (rng.standard_normal(w.shape) * 0.3).astype(np.float32)
    for name in ("b_q", "b_v"):
        if "lora" in tree:
            b = tree["lora"][name]
            tree["lora"][name] = (rng.standard_normal(b.shape) * 0.2).astype(np.float32)
    return tree


def _module(cls, tree, *args, **kwargs):
    m = cls(*args, **kwargs)
    m.load_state_dict(params_from_jax(tree), strict=True)
    return m


@pytest.fixture(scope="module")
def towers():
    """{name: (jax tree, port module, jax cfg, port cfg)} for the ViT and
    the BERT, with and without LoRA."""
    out = {}
    for lora in (0, LORA_RANK):
        vit_j, vit_p = ViTConfig(**VIT), port_schema.ViTConfig(**VIT)
        tree = _sharpen(numpy_params(lambda key: init_vit_params(key, vit_j, output_dim=16,
                                                                 lora_rank=lora), 3), 5)
        out[f"vit{lora}"] = (tree, _module(ViT, tree, vit_p, 16, lora), vit_j, vit_p)
        bert_j, bert_p = BertConfig(**BERT), port_schema.BertConfig(**BERT)
        tree = _sharpen(numpy_params(lambda key: init_bert_params(key, bert_j, lora_rank=lora),
                                     4), 6)
        out[f"bert{lora}"] = (tree, _module(Bert, tree, bert_p, lora), bert_j, bert_p)
    return out


@pytest.mark.parametrize("lora", [0, LORA_RANK])
def test_vit_probs_match_jax(towers, lora):
    tree, module, cfg_j, cfg_p = towers[f"vit{lora}"]
    images = np.random.default_rng(11).uniform(size=(3, 32, 32, 3)).astype(np.float32)
    want = jax_am.vit_attention_probs(tree, images, cfg_j)
    got = port_am.vit_attention_probs(module, images, cfg_p, device="cpu")
    assert got.shape == want.shape == (3, 3, 4, 17, 17) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)
    # the encoder's pytree goes in as well as its module
    np.testing.assert_array_equal(
        port_am.vit_attention_probs(tree, images, cfg_p, device="cpu"), got)
    assert float(np.abs(got - 1.0 / 17).max()) > 0.05  # not uniform attention


@pytest.mark.parametrize("lora", [0, LORA_RANK])
@pytest.mark.parametrize("masked", [False, True])
def test_bert_probs_match_jax(towers, lora, masked):
    tree, module, cfg_j, cfg_p = towers[f"bert{lora}"]
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 60, (3, 14)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((3, 14), np.int32)
        mask[0, 9:] = 0
        mask[2, 5:] = 0
    want = jax_am.bert_attention_probs(tree, ids, mask, cfg_j)
    got = port_am.bert_attention_probs(module, ids, mask, cfg_p, device="cpu")
    assert got.shape == want.shape == (3, 3, 4, 14, 14)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    if masked:
        assert got[:, 0, ..., 9:].max() < 1e-6 and got[:, 2, ..., 5:].max() < 1e-6


@pytest.mark.parametrize("head_fusion", ["max", "mean", "min"])
def test_rollout_is_the_jax_rollout(head_fusion):
    rng = np.random.default_rng(13)
    probs = rng.dirichlet(np.ones(17), size=(5, 3, 4, 17)).astype(np.float32)
    for kwargs in ({"layer_range": (1, -2)}, {"layer_idx": 2}, {"layer_range": (0, 0)}):
        got = port_am.attention_rollout(probs, 0.9, head_fusion, **kwargs)
        want = jax_am.attention_rollout(probs, 0.9, head_fusion, **kwargs)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    grid = np.random.default_rng(14).uniform(size=(4, 4)).astype(np.float32)
    image = np.random.default_rng(15).uniform(size=(32, 32, 3)).astype(np.float32)
    assert np.array_equal(port_am.overlay_mask(image, grid), jax_am.overlay_mask(image, grid))
    assert np.array_equal(port_am.mask_to_grid(got[0]), jax_am.mask_to_grid(got[0]))


def _capture(monkeypatch, module, into):
    """Record the masks each figure writer of `module` is given."""
    image_writer, dna_writer = module.save_image_attention_figure, module.save_dna_attention_figure

    def image(path, images, rows):
        into["image"] = {k: np.asarray(v) for k, v in rows.items()}
        return image_writer(path, images, rows)

    def dna(path, masks):
        into["dna"] = {k: np.asarray(v) for k, v in masks.items()}
        return dna_writer(path, masks)

    monkeypatch.setattr(module, "save_image_attention_figure", image)
    monkeypatch.setattr(module, "save_dna_attention_figure", dna)


def _cosines(a, b):
    a, b = a.reshape(len(a), -1).astype(np.float64), b.reshape(len(b), -1).astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_cli_attention_maps_matches_jax(tiny_hdf5, tmp_path, monkeypatch):
    """`attention-maps --modality both --device cpu` against the JAX
    package's command on the fixture, from one .npz of weights (also the
    'before' row): both figures written, every mask at cosine >= 0.999."""
    exp = tmp_path / "exp.yaml"
    exp.write_text(ATTN_EXP)
    mc = jax_load_config(experiment=str(exp)).model_config
    tree = numpy_params(lambda key: init_clibd_params(key, mc), 21)
    for enc in ("image_encoder", "dna_encoder"):
        tree[enc] = {**tree[enc], "blocks": {**tree[enc]["blocks"]}}
        w = tree[enc]["blocks"]["qkv_w"]
        tree[enc]["blocks"]["qkv_w"] = (np.random.default_rng(22).standard_normal(w.shape)
                                        * 0.3).astype(np.float32)
    save_params_npz(tree, str(tmp_path / "params.npz"))
    masks = {}
    for name, main, module, extra in (("jax", jax_main, jax_am, []),
                                      ("port", port_cli.main, port_am, ["--device", "cpu"])):
        masks[name] = {}
        _capture(monkeypatch, module, masks[name])
        out = tmp_path / name
        assert main(["attention-maps", "-e", str(exp), "--hdf5", tiny_hdf5, "--modality", "both",
                     "--split", "test_seen", "--out", str(out), "--n-samples", "4",
                     "--n-orders", "2", "--layer-range", "0", "-1",
                     "--before-ckpt", str(tmp_path / "params.npz"), *extra,
                     "pipeline.num_workers=0", "model_config.load_ckpt=true",
                     f"model_config.ckpt_path={tmp_path / 'params.npz'}"]) == 0
        assert (out / "image_attention_test_seen.png").stat().st_size > 0
        assert (out / "dna_attention_test_seen.png").stat().st_size > 0
    for modality in ("image", "dna"):
        want, got = masks["jax"][modality], masks["port"][modality]
        assert list(got) == list(want) and len(want) == 2
        for key in want:
            assert got[key].shape == want[key].shape
            cos = _cosines(got[key], want[key])
            assert cos.min() >= MASK_COSINE_MIN, (modality, key, cos)
