"""CLIBD tri-encoder model: the port of `clibd_tpu/models/clibd.py`.

`CLIBD` holds the encoders an `ExperimentConfig` enables -- ViT-B/16 for
images, BarcodeBERT for DNA, BERT-small plus a projection for text; or, with
`backbone: open_clip`, the CLIP vision and text towers (`clip.py`) beside
BarcodeBERT -- under the same names as the JAX param pytree, so
`convert.params_from_jax` maps one onto the other.  `clibd_apply` returns
L2-normalised per-modality embeddings and exp(logit_scale), with the BERT
and ViT blocks rematerialised as `remat` asks (the CLIP towers take no remat,
as in the reference).  `set_trainable` is the JAX package's `trainable_mask`
(`clibd.py:231-275`) as `requires_grad` flags.  A modality whose
`input_type` is not its raw input (`image` / `sequence`) reads
pre-extracted features through the MLP encoder (`mlp.py`); with
`image.simclr_ckpt_path` set, the fresh init loads a SimCLR-pretrained ViT
backbone (`load_simclr_vit_backbone`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config import ExperimentConfig
from ..utils.profiling import span
from .bert import Bert
from .clip import CLIPText, CLIPTextConfig, CLIPVision, CLIPVisionConfig, clip_normalize
from .layers import Linear
from .mlp import MLPEncoder
from .vit import ViT


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) as the reference writes it: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def dequantize_image(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """uint8 transport (BatchSpec.transport_uint8) → float [0, 1]; float
    inputs pass through."""
    if x is not None and x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def clip_configs(cfg: ExperimentConfig):
    """cfg.clip → (CLIPVisionConfig, CLIPTextConfig) (`clibd.py:41-55`)."""
    c = cfg.clip
    vcfg = CLIPVisionConfig(
        image_size=c.image_size, patch_size=c.patch_size, hidden_size=c.vision_hidden,
        num_layers=c.vision_layers, num_heads=c.vision_heads, mlp_dim=c.vision_mlp,
        embed_dim=c.embed_dim, activation=c.activation)
    tcfg = CLIPTextConfig(
        vocab_size=c.vocab_size, context_length=c.context_length, hidden_size=c.text_hidden,
        num_layers=c.text_layers, num_heads=c.text_heads, mlp_dim=c.text_mlp,
        embed_dim=c.embed_dim, activation=c.activation)
    return vcfg, tcfg


class CLIBD(nn.Module):
    def __init__(self, cfg: ExperimentConfig):
        super().__init__()
        self.simclr_ckpt_path = None
        lora_rank = 0 if cfg.disable_lora else cfg.lora_rank
        self.logit_scale = nn.Parameter(torch.tensor(cfg.init_logit_scale, dtype=torch.float32))
        self.image_encoder = self.clip_vision = self.dna_encoder = None
        self.language_encoder = self.language_proj = self.clip_text = None
        clip = cfg.backbone == "open_clip"
        vcfg, tcfg = clip_configs(cfg)
        if cfg.image.enable and clip:
            self.clip_vision = CLIPVision(vcfg, lora_rank=lora_rank)
        elif cfg.image.enable and cfg.image.input_type == "image":
            self.image_encoder = ViT(cfg.image.vit, output_dim=cfg.output_dim, lora_rank=lora_rank)
            self.simclr_ckpt_path = cfg.image.simclr_ckpt_path
        elif cfg.image.enable:
            self.image_encoder = MLPEncoder(cfg.image.input_dim, cfg.image.hidden_dim,
                                            cfg.output_dim)
        if cfg.dna.enable and (clip or cfg.dna.input_type == "sequence"):
            self.dna_encoder = Bert(cfg.dna.bert, lora_rank=lora_rank, head_dim=cfg.output_dim)
        elif cfg.dna.enable:
            self.dna_encoder = MLPEncoder(cfg.dna.input_dim, cfg.dna.hidden_dim, cfg.output_dim)
        if cfg.language.enable and clip:
            self.clip_text = CLIPText(tcfg, lora_rank=lora_rank)
        elif cfg.language.enable:
            self.language_encoder = Bert(cfg.language.bert, lora_rank=lora_rank)
            self.language_proj = Linear(cfg.language.bert.hidden_size, cfg.output_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Re-draw every encoder; logit_scale keeps its log(1/0.07) init.
        With `image.simclr_ckpt_path`, the ViT then takes the SimCLR backbone
        (`init_clibd_params`, `clibd.py:82-86`)."""
        for m in (self.image_encoder, self.clip_vision, self.dna_encoder, self.language_encoder,
                  self.language_proj, self.clip_text):
            if m is not None:
                m.reset_parameters(generator)
        if self.simclr_ckpt_path:
            load_simclr_vit_backbone(self.simclr_ckpt_path, self.image_encoder)


_SIMCLR_KEYS = ("patch_embed", "cls_token", "pos_embed", "blocks", "norm")


def load_simclr_vit_backbone(path: str, encoder: ViT) -> ViT:
    """Load SimCLR-pretrained ViT weights into `encoder` in place, keeping
    its head and LoRA (reference: a timm state dict with "module." stripped,
    then reset_classifier, simple_clip.py:157-166; `clibd.py:110-131`).
    `path`: an npz checkpoint directory, an `.npz` of the ViT's pytree, or a
    timm torch checkpoint (unpickled: trusted files only)."""
    import os

    from .convert import (load_params_npz, load_torch_state_dict, params_from_jax,
                          strip_module_prefix, vit_params_from_timm_state_dict)

    if os.path.isdir(path):
        loaded = load_params_npz(os.path.join(path, "params.npz"))
    elif path.endswith(".npz"):
        loaded = load_params_npz(path)
    else:
        sd = load_torch_state_dict(path)
        sd.pop("__meta__", None)
        loaded = vit_params_from_timm_state_dict(strip_module_prefix(sd), encoder.cfg,
                                                 output_dim=encoder.head.w.shape[1])
    state = params_from_jax({k: loaded[k] for k in _SIMCLR_KEYS if k in loaded})
    own = encoder.state_dict()
    bad = [k for k, v in state.items() if k not in own or own[k].shape != v.shape]
    if bad:
        raise ValueError(f"{path}: SimCLR backbone parameters that the ViT does not have "
                         f"or of other shapes: {bad[:12]}")
    encoder.load_state_dict(state, strict=False)
    return encoder


def set_trainable(model: CLIBD, cfg: ExperimentConfig) -> CLIBD:
    """Set `requires_grad` on every parameter as `trainable_mask` does.
    Reference semantics (simple_clip.py:100-246): with LoRA, backbones are
    frozen and only the LoRA A/B, the replaced heads (ViT head, DNA decoder,
    text projection) and logit_scale train; with `disable_lora`, everything
    trains.  logit_scale is frozen under `fix_temperature`, and a
    modality's `freeze` flag freezes that whole encoder (the text one with
    its projection; the CLIP towers follow the image and language flags).
    The MLP encoders of feature inputs train whole under LoRA too."""
    lora_heads = ("image_encoder.head.", "dna_encoder.mlm_head.decoder.", "language_proj.")
    frozen = [enc for enc, flag in (("image_encoder.", cfg.image.freeze),
                                    ("clip_vision.", cfg.image.freeze),
                                    ("dna_encoder.", cfg.dna.freeze),
                                    ("language_encoder.", cfg.language.freeze),
                                    ("language_proj.", cfg.language.freeze),
                                    ("clip_text.", cfg.language.freeze)) if flag]
    # the MLP encoders of feature inputs train whole
    mlps = tuple(f"{enc}." for enc in ("image_encoder", "dna_encoder")
                 if isinstance(getattr(model, enc), MLPEncoder))
    for name, p in model.named_parameters():
        if name == "logit_scale":
            train = not cfg.loss.fix_temperature
        else:
            train = (cfg.disable_lora or ".lora." in name or name.startswith(lora_heads)
                     or name.startswith(mlps))
            train = train and not name.startswith(tuple(frozen))
        p.requires_grad_(train)
    return model


def init_clibd_model(cfg: ExperimentConfig, generator: torch.Generator,
                     device: torch.device | str = "cuda") -> CLIBD:
    """Fresh init (`init_clibd_params`) from an explicit generator, with the
    trainable parameters set by `set_trainable`.  The numbers differ from
    jax.random's for the same seed; the distributions are the reference's."""
    model = CLIBD(cfg)
    model.reset_parameters(generator)
    return set_trainable(model, cfg).to(device)


def encode_image(model: CLIBD, cfg: ExperimentConfig, image_input, compute_dtype=torch.bfloat16,
                 remat=False):
    """Image features before normalisation: the MLP encoder on features, the
    CLIP vision tower on CLIP-normalised images (no remat), or the ViT."""
    if isinstance(model.image_encoder, MLPEncoder):
        return model.image_encoder(image_input, compute_dtype)
    images = dequantize_image(image_input)
    if model.clip_vision is not None:
        return model.clip_vision(clip_normalize(images), compute_dtype)
    return model.image_encoder(images, compute_dtype=compute_dtype, fast_math=cfg.fast_math,
                               remat=remat)


def encode_dna(model: CLIBD, cfg: ExperimentConfig, dna_tokens, compute_dtype=torch.bfloat16,
               remat=False):
    if isinstance(model.dna_encoder, MLPEncoder):
        return model.dna_encoder(dna_tokens, compute_dtype)
    attention_mask = None
    if isinstance(dna_tokens, dict):  # overlap tokenizer: {input_ids, attention_mask}
        attention_mask = dna_tokens.get("attention_mask")
        dna_tokens = dna_tokens["input_ids"]
    enc = model.dna_encoder
    hidden = enc(dna_tokens, attention_mask=attention_mask, compute_dtype=compute_dtype,
                 fast_math=cfg.fast_math, remat=remat)
    logits = enc.mlm_head_apply(hidden, compute_dtype, fast_math=cfg.fast_math).float()
    if cfg.dna.readout == "softmax_mean":
        # checkpoint-parity quirk (reference dna_encoder.py:131-137): softmax
        # over the decoder outputs, then mean over the sequence
        return torch.softmax(logits, dim=-1).mean(dim=1)
    return logits.mean(dim=1)


def encode_language(model: CLIBD, cfg: ExperimentConfig, language_input,
                    compute_dtype=torch.bfloat16, remat=False):
    """Text features before normalisation: the CLIP text tower on the ids
    (no remat), or BERT-small with its projection."""
    if model.clip_text is not None:
        ids = language_input["input_ids"] if isinstance(language_input, dict) else language_input
        return model.clip_text(ids, compute_dtype)
    hidden = model.language_encoder(
        language_input["input_ids"], token_type_ids=language_input.get("token_type_ids"),
        attention_mask=language_input.get("attention_mask"), compute_dtype=compute_dtype,
        fast_math=cfg.fast_math, remat=remat)
    # mean over ALL positions, padding included (reference
    # language_encoder.py:87-89)
    pooled = hidden.float().mean(dim=1)
    return model.language_proj(pooled, compute_dtype).float()


def clibd_apply(model: CLIBD, cfg: ExperimentConfig, image_input=None, dna_input=None,
                language_input: Optional[dict] = None,
                compute_dtype=torch.bfloat16, remat=False) -> Dict[str, Any]:
    """Forward pass → {image, dna, language}: L2-normalised [B, output_dim]
    fp32 (None where absent), and logit_scale exp()'d.  remat: as
    `layers.transformer_stack`."""
    out: Dict[str, Any] = {"image": None, "dna": None, "language": None}
    if image_input is not None and (model.image_encoder or model.clip_vision) is not None:
        with span("encode.image"):
            out["image"] = l2_normalize(encode_image(model, cfg, image_input, compute_dtype,
                                                     remat))
    if dna_input is not None and model.dna_encoder is not None:
        with span("encode.dna"):
            out["dna"] = l2_normalize(encode_dna(model, cfg, dna_input, compute_dtype, remat))
    if language_input is not None and (model.language_encoder or model.clip_text) is not None:
        with span("encode.language"):
            out["language"] = l2_normalize(encode_language(model, cfg, language_input,
                                                           compute_dtype, remat))
    out["logit_scale"] = torch.exp(model.logit_scale)
    return out
