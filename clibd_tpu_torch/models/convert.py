"""Weights for the port: the torch-checkpoint importers, the npz round-trip
and the bridge from the JAX param pytree to the port's modules.

The importers and the npz helpers are a copy of `clibd_tpu/models/convert.py`
(`:37-82`, `:94-321`, `:305-334`), which works on numpy and imports no jax:
the port keeps its own copy.  They read the three checkpoint families the
reference consumes -- timm `vit_base_patch16_224` state dicts, HF `BertModel`
/ `BertForMaskedLM` state dicts (raw BarcodeBERT checkpoints included) and
the released `best.pth` SimpleCLIP state dicts, plain or LoRA-wrapped, under
the legacy names too -- into the JAX package's numpy pytree: torch Linear
[out, in] → [in, out]; HF's separate q/k/v → one [D, 3D] qkv (q, k, v along
axis 1); per-layer tensors stacked [L, ...]; the patch conv OIHW → the
(h, w, c)-ordered matmul weight of `vit.patchify`.  `clip.clip_params_from_state_dict`
does the same for an open_clip state dict.

The port's modules use the pytree's own names and layouts, so the bridge
(`params_from_jax`, `model_from_jax`) is a renaming of paths ("a/b/c" →
"a.b.c") with no transposes.  `torch.load` runs with `weights_only=False`,
as in the JAX package, to open the same files: it unpickles, so load only
trusted checkpoints.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import BertConfig, ExperimentConfig, ViTConfig
from .clibd import CLIBD, set_trainable

# ---------------------------------------------------------------------------
# torch checkpoint IO
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint → {name: fp32 numpy array}; a raw BarcodeBERT
    `{"model", "bert_config"}` file keeps its other entries under
    "__meta__".  Unpickles (`weights_only=False`): trusted files only."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj and not any(
        hasattr(v, "numpy") for v in obj.values() if not isinstance(v, dict)
    ):
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        # raw BarcodeBERT checkpoints: {"model": sd, "bert_config": {...}}
        meta = {k: v for k, v in obj.items() if k != "model"}
        sd = obj["model"]
        out = {k: _to_np(v) for k, v in sd.items() if hasattr(v, "numpy")}
        out["__meta__"] = meta  # type: ignore
        return out
    return {k: _to_np(v) for k, v in obj.items() if hasattr(v, "numpy")}


def _to_np(t) -> np.ndarray:
    return t.detach().to("cpu").float().numpy()


def strip_module_prefix(sd: dict) -> dict:
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


_LEGACY_NAME_MAP = {
    "LoRA_barcode_bert": "CLIBDDNAEncoder",
    "lora_barcode_bert": "base_dna_encoder",
    "LoRA_ViT_timm": "CLIBDImageEncoder",
    "lora_vit": "base_image_encoder",
    "LoRA_bert": "CLIBDLanguageEncoder",
    "lora_bert": "base_language_encoder",
}


def migrate_legacy_param_names(sd: dict) -> dict:
    """Reference update_checkpoint_param_names (util/util.py:924-948)."""
    out = {}
    for name, tensor in sd.items():
        new = name
        for old, repl in _LEGACY_NAME_MAP.items():
            if old in new:
                new = new.replace(old, repl)
        out[new] = tensor
    return out


# ---------------------------------------------------------------------------
# ViT (timm) conversion
# ---------------------------------------------------------------------------


def _stack(layers):
    return np.stack(layers, axis=0)


def vit_params_from_timm_state_dict(
    sd: Dict[str, np.ndarray],
    cfg: ViTConfig,
    output_dim: int = 768,
    lora_rank: int = 0,
    prefix: str = "",
) -> dict:
    g = lambda k: np.asarray(sd[prefix + k])
    D = cfg.hidden_size
    # conv kernel OIHW [D,3,16,16] → [(h w c), D]
    kernel = g("patch_embed.proj.weight").transpose(2, 3, 1, 0).reshape(-1, D)
    params = {
        "patch_embed": {"w": kernel, "b": g("patch_embed.proj.bias")},
        "cls_token": g("cls_token"),
        "pos_embed": g("pos_embed"),
        "norm": {"scale": g("norm.weight"), "bias": g("norm.bias")},
    }
    blocks = {k: [] for k in (
        "qkv_w", "qkv_b", "out_w", "out_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
        "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
    )}
    lora = {k: [] for k in ("a_q", "b_q", "a_v", "b_v")} if lora_rank else None
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        qkv_key = p + "attn.qkv.weight"
        if prefix + qkv_key in sd:  # plain timm layout
            blocks["qkv_w"].append(g(qkv_key).T)
            blocks["qkv_b"].append(g(p + "attn.qkv.bias"))
        else:  # LoRA-wrapped layout (qkv.qkv.*)
            blocks["qkv_w"].append(g(p + "attn.qkv.qkv.weight").T)
            blocks["qkv_b"].append(g(p + "attn.qkv.qkv.bias"))
        if lora is not None:
            lora["a_q"].append(g(p + "attn.qkv.linear_a_q.weight").T)
            lora["b_q"].append(g(p + "attn.qkv.linear_b_q.weight").T)
            lora["a_v"].append(g(p + "attn.qkv.linear_a_v.weight").T)
            lora["b_v"].append(g(p + "attn.qkv.linear_b_v.weight").T)
        blocks["out_w"].append(g(p + "attn.proj.weight").T)
        blocks["out_b"].append(g(p + "attn.proj.bias"))
        blocks["fc1_w"].append(g(p + "mlp.fc1.weight").T)
        blocks["fc1_b"].append(g(p + "mlp.fc1.bias"))
        blocks["fc2_w"].append(g(p + "mlp.fc2.weight").T)
        blocks["fc2_b"].append(g(p + "mlp.fc2.bias"))
        blocks["ln1_scale"].append(g(p + "norm1.weight"))
        blocks["ln1_bias"].append(g(p + "norm1.bias"))
        blocks["ln2_scale"].append(g(p + "norm2.weight"))
        blocks["ln2_bias"].append(g(p + "norm2.bias"))
    params["blocks"] = {k: _stack(v) for k, v in blocks.items()}
    if lora is not None:
        params["lora"] = {k: _stack(v) for k, v in lora.items()}
    if prefix + "head.weight" in sd:
        params["head"] = {"w": g("head.weight").T, "b": g("head.bias")}
    else:
        params["head"] = {
            "w": np.zeros((D, output_dim), np.float32),
            "b": np.zeros((output_dim,), np.float32),
        }
    return params


# ---------------------------------------------------------------------------
# BERT (HF) conversion
# ---------------------------------------------------------------------------


def bert_params_from_hf_state_dict(
    sd: Dict[str, np.ndarray],
    cfg: BertConfig,
    prefix: str = "",
    lora_rank: int = 0,
    mlm_head_prefix: Optional[str] = None,
) -> dict:
    """prefix: e.g. "bert." for BertForMaskedLM, "" for BertModel.
    mlm_head_prefix: e.g. "cls.predictions." when converting an MLM head."""
    g = lambda k: np.asarray(sd[prefix + k])
    params = {
        "embeddings": {
            "word": g("embeddings.word_embeddings.weight")[: cfg.vocab_size],
            "position": g("embeddings.position_embeddings.weight"),
            "token_type": g("embeddings.token_type_embeddings.weight"),
            "ln": {
                "scale": g("embeddings.LayerNorm.weight"),
                "bias": g("embeddings.LayerNorm.bias"),
            },
        },
    }
    blocks = {k: [] for k in (
        "qkv_w", "qkv_b", "out_w", "out_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
        "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
    )}
    lora = {k: [] for k in ("a_q", "b_q", "a_v", "b_v")} if lora_rank else None
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        wrapped = prefix + p + "attention.self.query.w.weight" in sd
        sub = ".w" if wrapped else ""
        wq = g(p + f"attention.self.query{sub}.weight").T
        wk = g(p + "attention.self.key.weight").T
        wv = g(p + f"attention.self.value{sub}.weight").T
        bq = g(p + f"attention.self.query{sub}.bias")
        bk = g(p + "attention.self.key.bias")
        bv = g(p + f"attention.self.value{sub}.bias")
        blocks["qkv_w"].append(np.concatenate([wq, wk, wv], axis=1))
        blocks["qkv_b"].append(np.concatenate([bq, bk, bv], axis=0))
        if lora is not None:
            lora["a_q"].append(g(p + "attention.self.query.w_a.weight").T)
            lora["b_q"].append(g(p + "attention.self.query.w_b.weight").T)
            lora["a_v"].append(g(p + "attention.self.value.w_a.weight").T)
            lora["b_v"].append(g(p + "attention.self.value.w_b.weight").T)
        blocks["out_w"].append(g(p + "attention.output.dense.weight").T)
        blocks["out_b"].append(g(p + "attention.output.dense.bias"))
        blocks["ln1_scale"].append(g(p + "attention.output.LayerNorm.weight"))
        blocks["ln1_bias"].append(g(p + "attention.output.LayerNorm.bias"))
        blocks["fc1_w"].append(g(p + "intermediate.dense.weight").T)
        blocks["fc1_b"].append(g(p + "intermediate.dense.bias"))
        blocks["fc2_w"].append(g(p + "output.dense.weight").T)
        blocks["fc2_b"].append(g(p + "output.dense.bias"))
        blocks["ln2_scale"].append(g(p + "output.LayerNorm.weight"))
        blocks["ln2_bias"].append(g(p + "output.LayerNorm.bias"))
    params["blocks"] = {k: _stack(v) for k, v in blocks.items()}
    if lora is not None:
        params["lora"] = {k: _stack(v) for k, v in lora.items()}

    if cfg.with_mlm_head and mlm_head_prefix is not None:
        h = lambda k: np.asarray(sd[mlm_head_prefix + k])
        decoder_w = h("decoder.weight").T
        decoder_b = (
            np.asarray(sd[mlm_head_prefix + "decoder.bias"])
            if mlm_head_prefix + "decoder.bias" in sd
            else np.asarray(sd.get(mlm_head_prefix + "bias",
                                   np.zeros(decoder_w.shape[1], np.float32)))
        )
        params["mlm_head"] = {
            "transform": {"w": h("transform.dense.weight").T, "b": h("transform.dense.bias")},
            "ln": {"scale": h("transform.LayerNorm.weight"), "bias": h("transform.LayerNorm.bias")},
            "decoder": {"w": decoder_w, "b": decoder_b},
        }
    return params


def load_barcode_bert_checkpoint(path: str, cfg: Optional[BertConfig] = None) -> tuple:
    """Load a raw BarcodeBERT checkpoint (reference load_pre_trained_bioscan_bert).
    Returns (params_without_replaced_decoder, BertConfig)."""
    sd = load_torch_state_dict(path)
    meta = sd.pop("__meta__", {}) if "__meta__" in sd else {}
    sd = strip_module_prefix(sd)
    if cfg is None:
        bc = meta.get("bert_config", {}) if isinstance(meta, dict) else {}
        cfg = BertConfig(
            vocab_size=bc.get("vocab_size", 1027),
            hidden_size=bc.get("hidden_size", 768),
            num_layers=bc.get("num_hidden_layers", 12),
            num_heads=bc.get("num_attention_heads", 12),
            intermediate_size=bc.get("intermediate_size", 3072),
            max_position_embeddings=bc.get("max_position_embeddings", 512),
            with_mlm_head=True,
        )
    params = bert_params_from_hf_state_dict(
        sd, cfg, prefix="bert.", lora_rank=0, mlm_head_prefix="cls.predictions."
    )
    return params, cfg


# ---------------------------------------------------------------------------
# Full CLIBD checkpoint (released best.pth) conversion
# ---------------------------------------------------------------------------


def clibd_params_from_reference_checkpoint(
    sd: Dict[str, np.ndarray], cfg: ExperimentConfig
) -> dict:
    """Convert a SimpleCLIP state_dict into a full clibd_tpu param pytree.  A
    tower gets a "lora" subtree only when the checkpoint has its adapters."""
    sd = migrate_legacy_param_names(strip_module_prefix(sd))
    lora_rank = 0 if cfg.disable_lora else cfg.lora_rank
    params: dict = {"logit_scale": np.asarray(sd["logit_scale"], np.float32).reshape(())}

    if any(k.startswith("image_encoder.") for k in sd):
        has_lora = any("linear_a_q" in k for k in sd)
        vit_sd = {k[len("image_encoder.base_image_encoder."):]: v
                  for k, v in sd.items() if k.startswith("image_encoder.base_image_encoder.")}
        params["image_encoder"] = vit_params_from_timm_state_dict(
            vit_sd, cfg.image.vit, output_dim=cfg.output_dim,
            lora_rank=lora_rank if has_lora else 0,
        )
    if any(k.startswith("dna_encoder.") for k in sd):
        dna_sd = {k[len("dna_encoder.base_dna_encoder."):]: v
                  for k, v in sd.items() if k.startswith("dna_encoder.base_dna_encoder.")}
        has_lora = any(".w_a." in k for k in dna_sd)
        params["dna_encoder"] = bert_params_from_hf_state_dict(
            dna_sd, cfg.dna.bert, prefix="bert.",
            lora_rank=lora_rank if has_lora else 0,
            mlm_head_prefix="cls.predictions.",
        )
    if any(k.startswith("language_encoder.") for k in sd):
        lang_sd = {k[len("language_encoder.base_language_encoder."):]: v
                   for k, v in sd.items() if k.startswith("language_encoder.base_language_encoder.")}
        has_lora = any(".w_a." in k for k in lang_sd)
        params["language_encoder"] = bert_params_from_hf_state_dict(
            lang_sd, cfg.language.bert, prefix="",
            lora_rank=lora_rank if has_lora else 0,
        )
        params["language_proj"] = {
            "w": np.asarray(sd["language_encoder.proj.weight"]).T,
            "b": np.asarray(sd["language_encoder.proj.bias"]),
        }
    return params


# ---------------------------------------------------------------------------
# npz round-trip
# ---------------------------------------------------------------------------


def flatten_pytree(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_pytree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_pytree(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(params: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten_pytree(params))


def load_params_npz(path: str) -> dict:
    with np.load(path) as data:
        return unflatten_pytree({k: data[k] for k in data.files})


# ---------------------------------------------------------------------------
# pytree → modules
# ---------------------------------------------------------------------------


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy leaves) → the port's state dict (copies)."""
    return {key.replace("/", "."): torch.from_numpy(np.array(v, dtype=np.float32))
            for key, v in flatten_pytree(tree).items()}


_TOWERS = ("image_encoder", "clip_vision", "dna_encoder", "language_encoder", "clip_text")


def model_from_jax(tree: dict, cfg: ExperimentConfig,
                   device: torch.device | str = "cuda") -> CLIBD:
    """Build the `CLIBD` module for `cfg` and load the pytree into it.  A
    tower runs LoRA only where the pytree holds its "lora" subtree, as the
    JAX forward does (a released checkpoint without adapters under a LoRA
    recipe); every other parameter must be present and of the same shape.
    The trainable parameters are set by `set_trainable`.  The module is
    built on the meta device and takes the converted tensors as they are,
    so the host holds no third copy of the weights."""
    with torch.device("meta"):
        model = CLIBD(cfg)
    for name in _TOWERS:
        tower = getattr(model, name)
        if getattr(tower, "lora", None) is not None and "lora" not in tree.get(name, {}):
            tower.lora = None
    state = params_from_jax(tree)
    want = dict(model.named_parameters())
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        towers = sorted({k.split(".")[0] for k in missing})
        raise RuntimeError(f"the checkpoint does not match the config: missing {len(missing)} "
                       f"parameters (of {towers}: {missing[:12]}), unexpected "
                       f"{unexpected[:12]}")
    bad = [(k, tuple(state[k].shape), tuple(p.shape)) for k, p in want.items()
           if state[k].shape != p.shape]
    if bad:
        raise RuntimeError(f"checkpoint shapes differ from the config's: {bad[:12]}")
    model.load_state_dict(state, strict=True, assign=True)
    return set_trainable(model, cfg).to(device)
