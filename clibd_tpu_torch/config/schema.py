# A copy of clibd_tpu/config/schema.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Typed configuration schema.

The reference (bioscan-ml/clibd) drives everything through Hydra YAMLs with
`hasattr`-probed optional fields (`bioscanclip/config/global_config.yaml`,
`config/MODEL_CONFIG.md`).  Here the same two-level split — a *global* config
(paths, eval settings) composed with an *experiment* config (modalities,
encoders, optimization) — is expressed as dataclasses with explicit defaults,
loadable from YAML with dotted CLI overrides (see loader.py).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

LEVELS = ("order", "family", "genus", "species")


# ---------------------------------------------------------------------------
# Encoder configs
# ---------------------------------------------------------------------------


@dataclass
class ViTConfig:
    """ViT-B/16 by default (reference: timm `vit_base_patch16_224`,
    `bioscanclip/model/simple_clip.py:150-156`)."""

    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    layernorm_eps: float = 1e-6
    # number of prefix tokens (CLS)
    num_prefix_tokens: int = 1

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + self.num_prefix_tokens


@dataclass
class BertConfig:
    """Generic BERT encoder config.

    Used for both BarcodeBERT (5-mer vocab of 4^5 + 3 specials = 1027,
    reference `bioscanclip/model/dna_encoder.py:24-28`) and BERT-small
    (prajjwal1/bert-small: hidden 512, 4 layers, 8 heads).
    """

    vocab_size: int = 1027
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layernorm_eps: float = 1e-12
    pad_token_id: int = 0
    # Whether the model carries an MLM prediction head (BarcodeBERT does:
    # transform dense + gelu + LN + decoder; reference replaces the decoder
    # with a Linear to output_dim, dna_encoder.py:125-127).
    with_mlm_head: bool = False


def bert_small_config(vocab_size: int = 30522) -> BertConfig:
    """prajjwal1/bert-small architecture (reference language encoder)."""
    return BertConfig(
        vocab_size=vocab_size,
        hidden_size=512,
        num_layers=4,
        num_heads=8,
        intermediate_size=2048,
        with_mlm_head=False,
    )


def barcode_bert_config(vocab_size: int = 1027) -> BertConfig:
    """BarcodeBERT architecture (BERT-base MLM over 5-mer vocab)."""
    return BertConfig(vocab_size=vocab_size, with_mlm_head=True)


# ---------------------------------------------------------------------------
# Modality configs (mirror reference model_config.{image,dna,language})
# ---------------------------------------------------------------------------


@dataclass
class ImageModalityConfig:
    enable: bool = True
    input_type: str = "image"  # "image" | "feature"
    model: str = "vit"  # "vit" | "mlp"
    # MLP path (pre-extracted features), reference simple_clip.py:176-179
    input_dim: int = 512
    hidden_dim: int = 768
    freeze: bool = False
    # optional SimCLR-pretrained backbone checkpoint to load
    simclr_ckpt_path: Optional[str] = None
    vit: ViTConfig = field(default_factory=ViTConfig)


@dataclass
class DNAModalityConfig:
    enable: bool = True
    input_type: str = "sequence"  # "sequence" | "feature"
    model: str = "barcode_bert"
    input_dim: int = 768
    hidden_dim: int = 768
    freeze: bool = False
    kmer: int = 5
    max_bp: int = 660  # barcode padded/truncated length (reference util.py:77-85)
    # which pretrained BarcodeBERT checkpoint family (reference
    # `pre_train_for_barcode_bert`): "" | "BIOSCAN-5M" | "CANADA-1-5M"
    pretrained_variant: str = ""
    # DNA tokenizer: "kmer" = non-overlapping 5-mers + prepended id 0
    # (dna_encoder.py:53-63); "overlap" = the new-BarcodeBERT k-mer stride-1
    # tokenizer with attention mask (reference NewKmerTokenizer,
    # util/util.py:101-126 / the AutoTokenizer("bioscan-ml/BarcodeBERT")
    # batch-time path, epoch/train_epoch.py:33-40)
    tokenizer: str = "kmer"
    stride: int = 1  # overlap tokenizer stride
    # checkpoint-parity readout: softmax over head outputs then mean over
    # sequence (reference dna_encoder.py:131-137). "clean" = mean of final
    # hidden states (the fix the reference authors said they would make).
    readout: str = "softmax_mean"  # "softmax_mean" | "hidden_mean"
    bert: BertConfig = field(default_factory=barcode_bert_config)

    @property
    def seq_len(self) -> int:
        if self.tokenizer == "overlap":
            return (self.max_bp - self.kmer) // self.stride + 1
        # prepended token id 0 + non-overlapping k-mers (dna_encoder.py:53-63)
        return 1 + self.max_bp // self.kmer


@dataclass
class LanguageModalityConfig:
    enable: bool = True
    input_type: str = "sequence"
    model: str = "bert_small"
    freeze: bool = False
    max_len: int = 20  # reference dataset.py:280-281
    bert: BertConfig = field(default_factory=bert_small_config)


# ---------------------------------------------------------------------------
# Loss / optimization
# ---------------------------------------------------------------------------


@dataclass
class LossConfig:
    """Mirrors reference `loss_setup` + top-level flags.

    all_gather=True → global-batch contrastive loss (features+labels gathered
    across the data axis inside the jitted step; reference loss_func.py:138-157).
    """

    all_gather: bool = True
    gather_with_grad: bool = True
    local_loss: bool = False
    # restrict pairs to those touching this modality (ImageBind-style,
    # reference loss_func.py:167-179): "" | "image" | "dna" | "text"
    bind_to: str = ""
    no_image_text_loss: bool = False
    fix_temperature: bool = False  # if True, logit_scale := 1/0.07 (train_epoch.py:33)


@dataclass
class LRConfig:
    lr: float = 1e-6
    max_lr: float = 5e-5
    # one_cycle internals (torch OneCycleLR defaults)
    pct_start: float = 0.3
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    # exponential (reference ExponentialLR gamma=0.95, train_cl.py:238)
    gamma: float = 0.95
    # step (reference StepLR step_size=10 gamma=0.5, train_cl.py:240)
    step_size: int = 10
    step_gamma: float = 0.5
    # cosine floor (reference train_cl.py:242-246: lr_config.min_lr, default
    # 1e-9, scaled by batch like lr)
    min_lr: float = 1e-9


@dataclass
class OptimConfig:
    optimizer: str = "adamw"
    lr_scheduler: str = "one_cycle"  # one_cycle | exponential | step | cosine | none
    lr_config: LRConfig = field(default_factory=LRConfig)
    weight_decay: float = 0.01  # torch AdamW default
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # LR scaled by total_batch/500 (reference util/util.py:753-756)
    base_batch_size: int = 500
    scale_lr_by_batch: bool = True
    grad_clip_norm: float = 0.0  # 0 = off


# ---------------------------------------------------------------------------
# Experiment (model_config equivalent)
# ---------------------------------------------------------------------------


@dataclass
class CLIPBackboneConfig:
    """OpenCLIP/BioCLIP backbone settings (reference `using_open_clip` /
    `for_bio_clip`, simple_clip.py:140-147): one CLIP model supplies both the
    image and text encoders; DNA stays BarcodeBERT."""

    # vision tower (ViT-L/14 defaults)
    image_size: int = 224
    patch_size: int = 14
    vision_hidden: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    vision_mlp: int = 4096
    # text tower
    vocab_size: int = 49408
    context_length: int = 77
    text_hidden: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_mlp: int = 3072
    embed_dim: int = 768
    activation: str = "gelu"  # "quick_gelu" for OpenAI-pretrained weights
    checkpoint: str = ""  # open_clip state_dict (.pt) or converted .npz
    bpe_path: str = ""  # CLIP BPE merges file


@dataclass
class ExperimentConfig:
    model_output_name: str = "image_dna_text"
    dataset: str = "bioscan_1m"  # bioscan_1m | bioscan_5m | INSECT
    batch_size: int = 500
    epochs: int = 50
    evaluation_period: int = 1
    eval_skip_epoch: int = -1
    output_dim: int = 768
    disable_lora: bool = False  # True = full fine-tune (final recipes)
    lora_rank: int = 4
    amp: bool = True  # bf16 compute
    # train-step parallelism implementation: "global" = global-math jit (XLA
    # partitioner inserts collectives); "shard_map" = explicit lax.all_gather
    # loss + psum grads with per-device local shapes (flash-attention
    # compatible on multi-chip meshes).  Numerically equivalent (tested).
    step_impl: str = "global"
    # fast-math under bf16 compute only: tanh-approx GELU + bf16 LN arithmetic
    # (fp32 mean/var).  Added error is below bf16 rounding noise (validated in
    # tests/test_models.py::test_fast_math_embedding_parity); −21% encoder wall
    # time (docs/PERF.md).  fp32 runs are unaffected (exact erf/fp32 LN).
    fast_math: bool = True
    # rematerialize transformer blocks in the backward pass (jax.checkpoint)
    # — trades ~30% step FLOPs for O(layers) activation memory; needed for
    # the reference's batch-500 recipes on 16GB v5e HBM
    remat: bool = True
    # which intermediates remat SAVES instead of recomputing ("none" =
    # blanket recompute; "attn"/"qkv"/"mlp" or "+"-joined combinations, or
    # "dots").  "attn" keeps the flash-attention forward from running a
    # third time per step (remat recompute on top of the kernel backward's
    # internal P recompute) for +[B,N,D] bf16 per layer of HBM.  Swept on
    # v5e (docs/PERF.md round-4 ledger): heavier policies ("attn+mlp",
    # "dots") exceed 16GB HBM at the reference's batch-500 tri-modal
    # recipe, so "attn" is the widest policy that fits the flagship
    # workload.  Policies never change the math, only what is stored.
    remat_policy: str = "attn"
    # gradient-cache microbatch accumulation (engine/train.
    # make_train_step_accum): >1 splits each batch into k microbatches with
    # the EXACT full-batch contrastive loss/grads (two-pass GradCache
    # construction) at ~1/k the activation memory — an alternative or
    # complement to remat for batches that exceed HBM.  1 = monolithic step.
    accum_steps: int = 1
    # mid-epoch failure recovery: also write last/ every N optimizer steps
    # (0 = epoch cadence only, the reference's behavior).  Resume realigns
    # to the exact batch via the loader's start_batch + batch-indexed
    # augmentation keys, so a killed run continues bit-exact.
    checkpoint_every_steps: int = 0
    random_seed: bool = False
    default_seed: int = 42
    using_train_seen_for_pre_train: bool = True
    train_with_small_subset: bool = False
    bin_for_positive_and_negative_pairs: bool = False
    # eval transform variant (reference `transform_with_resize`)
    transform_with_resize: bool = False
    # strict reference-output parity: require ALL THREE modalities before
    # emitting the all_key_features gallery (reference util/util.py:726-731);
    # default False relaxes to >=2 so image+DNA models keep the All column
    parity_strict: bool = False
    load_ckpt: bool = True
    ckpt_path: str = ""

    # "default" = ViT-B/16 + BERT-small; "open_clip" = CLIP towers for
    # image+text (reference using_open_clip / for_bio_clip)
    backbone: str = "default"
    clip: CLIPBackboneConfig = field(default_factory=CLIPBackboneConfig)

    image: ImageModalityConfig = field(default_factory=ImageModalityConfig)
    dna: DNAModalityConfig = field(default_factory=DNAModalityConfig)
    language: LanguageModalityConfig = field(default_factory=LanguageModalityConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)

    @property
    def enabled_modalities(self) -> tuple:
        mods = []
        if self.image.enable:
            mods.append("image")
        if self.dna.enable:
            mods.append("dna")
        if self.language.enable:
            mods.append("language")
        return tuple(mods)

    @property
    def init_logit_scale(self) -> float:
        return math.log(1.0 / 0.07)


# ---------------------------------------------------------------------------
# Global config (paths, eval settings, run settings)
# ---------------------------------------------------------------------------


@dataclass
class RetrieveSettings:
    num_queries: int = 5
    max_k: int = 3
    seed: int = 413
    independent: bool = False
    load_cached_results: bool = False
    # sample only mispredicted queries (reference scripts/result/check_failure_cases.py)
    only_failures: bool = False


@dataclass
class EvalConfig:
    plot_embeddings: bool = True  # reference global_config.yaml:41 default
    retrieve_images: bool = False
    # nearest same-species distance CSV + histogram per modality pair
    # (reference scripts/result/distribution_of_similarities.py)
    similarity_distributions: bool = False
    k_list: Sequence[int] = (1, 3, 5)
    levels: Sequence[str] = LEVELS
    eval_on: str = "test"  # val | test
    embeddings_filters: dict = field(
        default_factory=lambda: {"order": "Diptera", "family": "Sciaridae", "genus": "Corynoptera"}
    )
    retrieve_settings: RetrieveSettings = field(default_factory=RetrieveSettings)
    # query batch size for the on-device kNN
    knn_query_chunk: int = 4096


@dataclass
class DataPathsConfig:
    dir: str = ""
    path_to_hdf5_data: str = ""
    path_to_smaller_hdf5_data: str = ""
    path_to_tsv_data: str = ""
    path_to_id_to_position_mapping: str = ""


@dataclass
class InsectPathsConfig:
    dir: str = ""
    path_to_att_splits_mat: str = ""
    path_to_res_101_mat: str = ""
    path_to_image_hdf5: str = ""
    path_to_meta_csv: str = ""
    species_to_other: str = ""


@dataclass
class PipelineConfig:
    """Host input-pipeline settings (replaces torch DataLoader workers)."""

    num_workers: int = 4
    prefetch_batches: int = 2
    drop_last_train: bool = True
    use_native_decoder: bool = True  # C++ libjpeg decode pool when built
    shuffle_buffer_seed: int = 0


@dataclass
class GlobalConfig:
    project_root_path: str = "."
    data_dir: str = "data"
    model_output_dir: str = "ckpt/bioscan_clip"
    version: str = "ver_1_0"
    hf_repo_id: str = "bioscan-ml/clibd"
    activate_wandb: bool = False
    save_inference: bool = True
    load_inference: bool = False
    enable_early_stopping: bool = False
    save_ckpt: bool = True
    debug_flag: bool = False
    # pretrained backbone weights (converted .npz/.msgpack or torch .pth)
    bioscan_bert_checkpoint: str = ""
    vit_checkpoint: str = ""
    bert_small_checkpoint: str = ""
    bert_small_vocab: str = ""  # vocab.txt for WordPiece tokenization

    bioscan_data: DataPathsConfig = field(default_factory=DataPathsConfig)
    bioscan_5m_data: DataPathsConfig = field(default_factory=DataPathsConfig)
    insect_data: InsectPathsConfig = field(default_factory=InsectPathsConfig)
    inference_and_eval_setting: EvalConfig = field(default_factory=EvalConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    model_config: ExperimentConfig = field(default_factory=ExperimentConfig)


# ---------------------------------------------------------------------------
# (de)serialization helpers
# ---------------------------------------------------------------------------


def _merge_into(instance, data: dict):
    """Merge a nested dict of overrides into a dataclass instance (in place-ish)."""
    for key, value in data.items():
        if not hasattr(instance, key):
            raise KeyError(f"Unknown config key {key!r} for {type(instance).__name__}")
        current = getattr(instance, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge_into(current, value)
        else:
            setattr(instance, key, value)
    return instance


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def from_dict(data: dict) -> GlobalConfig:
    return _merge_into(GlobalConfig(), data)


def set_by_path(cfg: Any, dotted: str, value: Any) -> None:
    """Set `a.b.c=value` on a nested dataclass tree."""
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"Unknown config path {dotted!r}")
    current = getattr(obj, leaf)
    if current is not None and not dataclasses.is_dataclass(current):
        ctype = type(current)
        if ctype is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes", "on")
        elif ctype is int and isinstance(value, (str, float)):
            # YAML parses `epochs=20.0` as float; accept integral values for
            # int fields, reject fractional ones loudly (int("3.5") and a
            # silently-float epochs both break downstream range()/indexing)
            f = float(value)
            if f != int(f):
                raise ValueError(f"{dotted}={value!r}: int field given a fractional value")
            value = int(f)
        elif ctype is float and isinstance(value, str):
            value = float(value)
    setattr(obj, leaf, value)
