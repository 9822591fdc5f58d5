"""The tiny tri-modal model the port's training tests share: 2 layers,
narrow widths, fp32, in both packages' config classes, its JAX params and a
batch made from a numpy seed."""

import numpy as np
import torch

import jax

from clibd_tpu.config.schema import BertConfig, ExperimentConfig, ViTConfig
from clibd_tpu.models import init_clibd_params
from clibd_tpu_torch.config import schema as port_schema


def tiny_cfg(cls=ExperimentConfig, bert=BertConfig, vit=ViTConfig, **over):
    cfg = cls()
    cfg.amp = False
    cfg.image.vit = vit(image_size=32, patch_size=16, hidden_size=128, num_layers=2,
                        num_heads=2, mlp_dim=256)
    cfg.dna.max_bp = 80  # 1 + 80/5 = 17 tokens
    cfg.dna.bert = bert(vocab_size=1027, hidden_size=128, num_layers=2, num_heads=2,
                        intermediate_size=256, max_position_embeddings=40, with_mlm_head=True)
    cfg.language.bert = bert(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                             intermediate_size=256, max_position_embeddings=24)
    cfg.language.max_len = 20
    cfg.output_dim = 64
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def numpy_params(init, seed, block_std=0.02):
    """A weight set in the JAX package's layout for `init(key)`, from numpy
    seeded by `seed`, the tree's shapes traced and `init` not run (its
    op-by-op run takes seconds): LayerNorm scales 1, biases 0, the stacked
    blocks' matrices N(0, block_std) and every other weight N(0, 0.02)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = path[-1].key
        if name.endswith("scale"):
            return np.ones(shape.shape, np.float32)
        if name in ("b", "bias") or name.endswith(("_b", "_bias")):
            return np.zeros(shape.shape, np.float32)
        std = block_std if len(path) > 1 and path[-2].key == "blocks" else 0.02
        return (rng.standard_normal(shape.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_tiny_cfg(**over):
    return tiny_cfg(port_schema.ExperimentConfig, port_schema.BertConfig, port_schema.ViTConfig,
                    **over)


def tiny_batch(seed=1, B=4):
    rng = np.random.default_rng(seed)
    att = (rng.random((B, 20)) > 0.3).astype(np.int32)
    att[:, 0] = 1
    ids = rng.integers(1, 300, (B, 20)).astype(np.int32) * att
    return {"image": rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8),
            "dna": rng.integers(0, 1027, (B, 17)).astype(np.int32),
            "language": {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                         "attention_mask": att},
            "label": np.array([0, 1, 0, 2, 3, 1][:B])}


def to_torch(x):
    return {k: to_torch(v) for k, v in x.items()} if isinstance(x, dict) else torch.from_numpy(x)


_TREES: dict = {}


def tiny_tree(disable_lora=True):
    """JAX params of the tiny model (with LoRA adapters unless
    disable_lora), with larger qkv weights so attention is far from
    uniform."""
    if disable_lora not in _TREES:
        tree = jax.tree.map(np.asarray, init_clibd_params(jax.random.PRNGKey(5),
                                                          tiny_cfg(disable_lora=disable_lora)))
        for enc in ("image_encoder", "dna_encoder", "language_encoder"):
            w = tree[enc]["blocks"]["qkv_w"]
            tree[enc]["blocks"]["qkv_w"] = (np.random.default_rng(6).standard_normal(w.shape)
                                            * 0.1).astype(np.float32)
        _TREES[disable_lora] = tree
    return _TREES[disable_lora]
