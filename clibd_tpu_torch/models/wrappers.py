"""Aux model wrappers: the port of `clibd_tpu/models/wrappers.py` (reference
component #10), the frozen-backbone + extra-classifier-head combinations of
the fine-tune and linear-probe scripts (`EncoderWithExtraLayer`
util/util.py:42-54, `ViTWIthExtraLayer` vit_with_mlp.py,
`BarcodeBERT_And_MLP` barcode_bert_with_mlp.py).

As in the JAX package they are closures over an encoder's apply function
and a linear head; `params` holds modules (the encoder or backbone, the
head or MLP) instead of pytrees."""

from __future__ import annotations

from typing import Callable

import torch

from .layers import Linear


def init_extra_layer(generator: torch.Generator, feature_dim: int, num_classes: int) -> Linear:
    """A torch-default-initialised Linear(feature_dim, num_classes)."""
    head = Linear(feature_dim, num_classes)
    head.reset_parameters(generator)
    return head


def encoder_with_extra_layer(encode_fn: Callable) -> Callable:
    """encode_fn(encoder, x) → features; returns apply(params, x) → logits
    where params = {'encoder': ..., 'head': Linear}."""

    def apply(params, x, compute_dtype=torch.bfloat16, return_features: bool = False):
        feats = encode_fn(params["encoder"], x)
        if return_features:
            return feats
        return params["head"](feats, compute_dtype).float()

    return apply


def frozen_backbone_with_mlp(encode_fn: Callable, mlp_apply: Callable) -> Callable:
    """ViT_And_MLP / BarcodeBERT_And_MLP: frozen backbone features feed a
    trainable MLP head; no gradient reaches the backbone (the JAX package's
    stop_gradient)."""

    def apply(params, x, compute_dtype=torch.bfloat16):
        with torch.no_grad():
            feats = encode_fn(params["backbone"], x)
        return mlp_apply(params["mlp"], feats.detach(), compute_dtype)

    return apply
