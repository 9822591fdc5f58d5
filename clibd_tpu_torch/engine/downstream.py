"""The paper's downstream evaluations beyond the kNN grid, as engine
functions: the bodies of `clibd_tpu/cli/eval_cmds.py::cmd_method_nn`
(`:299-495`, seen/unseen threshold fusion, reference scripts/method_nn.py and
scripts/method_linear.py), `cmd_zeroshot` (`:180-298`, CLIP/BioCLIP
zero-shot, reference scripts/bioclip/) and `clibd_tpu/cli/extract_cmds.py::
cmd_bzsl_extract` (`:47-84`, INSECT features to the BZSL CSVs, reference
scripts/BZSL/extract_feature_for_insect_dataset.py), on one device.

Each takes a loader factory `make_loader(split, spec) -> loader` (the
`BioscanLoader` interface: `batches`, `label_dicts`, `ids`, `close`,
`len()`), so the commands pass factories of `BioscanLoader` / `INSECTLoader`
and a caller without the HDF5 files passes one of `data/synthetic.py`'s
`SyntheticSplit`.  The encoders run where the model's parameters lie.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..config import LEVELS
from ..data.clip_tokenizer import CLIPTokenizer
from ..data.insect import export_bzsl_csvs
from ..data.pipeline import BatchSpec
from ..models.clibd import clip_configs, dequantize_image
from ..models.clip import CLIPText, CLIPVision, clip_normalize, clip_params_from_state_dict
from ..models.convert import load_torch_state_dict, params_from_jax
from ..ops.knn import knn_search
from ..utils.metrics import (labels_to_level_arrays, predictions_to_level_arrays,
                             top_k_macro_accuracy, top_k_micro_accuracy)
from .extract import extract_split, to_device
from .finetune import fit_classifier, species_to_index
from .fusion import (class_labels_by_level_from_map, fit_frozen_probe, method_from_classifier,
                     method_linear, method_nn, predictions_from_logits)
from .schedules import one_cycle_lr
from .zeroshot import build_class_prototypes, taxon_prompt, zero_shot_classify


def method_nn_eval(model, mc, make_loader: Callable, eval_on: str = "val",
                   k_list: Sequence[int] = (1, 3, 5), unseen_keys_split: str = "unseen_keys",
                   side_b_query: str = "image", linear: bool = False, probe: str = "frozen",
                   probe_steps: int = 500, probe_epochs: int = 5,
                   train_split: str = "seen_keys", progress: bool = False,
                   record: dict = None) -> dict:
    """Seen/unseen threshold fusion (`cmd_method_nn`): image-query-vs-seen-
    keys similarity routes confident queries, the search against the unseen
    DNA keys handles the rest, and the threshold maximises the harmonic mean
    of seen/unseen species top-1.  With `linear`, side A is a linear probe
    over the image features of `train_split`, fitted once; with `probe=
    "full"`, the whole image encoder and a new head fine-tuned
    (`engine/finetune.fit_classifier`, AdamW 1e-4 + OneCycleLR, over an
    augmenting train loader).  The threshold is searched on the val queries
    and applied to the `eval_on` ones.  `record`, when given, receives the
    probe's per-step losses, under "frozen_probe_losses" or
    "probe_step_losses" (the full probe's).  → the command's summary dict."""
    device = next(model.parameters()).device
    spec = BatchSpec(batch_size=mc.batch_size, train=False, with_image=True, with_dna=True,
                     with_language=mc.language.enable,
                     clip_tokenizer=BatchSpec.maybe_clip_tokenizer(mc))
    image_spec = BatchSpec(batch_size=mc.batch_size, train=False, with_image=True,
                           with_dna=False, with_language=False)
    cache: dict = {}

    def run(split):
        if split not in cache:
            loader = make_loader(split, spec)
            try:
                cache[split] = extract_split(model, mc, loader, progress=progress)
            finally:
                loader.close()
        return cache[split]

    def run_concat(splits):
        """Comma-separated splits → one concatenated key set (the reference
        always concatenates val_unseen_keys + test_unseen_keys,
        method_nn.py:181-203; the pooled `unseen_keys` group is that union)."""
        outs = [run(s) for s in splits.split(",")]
        if len(outs) == 1:
            return outs[0]
        return {
            "encoded_dna_feature": np.concatenate([o["encoded_dna_feature"] for o in outs]),
            "label_list": [lab for o in outs for lab in o["label_list"]],
        }

    unseen_keys = run_concat(unseen_keys_split)
    common_kw = dict(max_k=max(k_list), k_list=list(k_list), side_b_query=side_b_query,
                     device=device)
    species_map: dict = {}

    def train_species_map():
        """(sorted classes, species→levels) from the probe-training split's
        labels, read without extracting it: the --probe full branch consumes
        only the labels."""
        if not species_map:
            if train_split in cache:
                train_labels = cache[train_split]["label_list"]
            else:
                loader = make_loader(train_split, spec)
                train_labels = loader.label_dicts()
                loader.close()
            species_to_levels: dict = {}
            for lab in train_labels:
                species_to_levels.setdefault(lab["species"], {lv: lab[lv] for lv in LEVELS})
            species_map["classes"] = sorted(species_to_levels)
            species_map["levels"] = species_to_levels
        return species_map["classes"], species_map["levels"]

    ft: dict = {}

    def finetuned_logits(split):
        """Logits of the fully fine-tuned image classifier on a query split
        (reference method_linear.py:458-516: a copy of the image encoder and
        a new head, every one of their parameters trained)."""
        if "predict" not in ft:
            classes, _ = train_species_map()
            train_loader = make_loader(train_split, BatchSpec(
                batch_size=mc.batch_size, train=True, with_image=True, with_dna=False,
                with_language=False))
            targets = species_to_index(train_loader.label_dicts(), classes)
            total_steps = max(1, len(train_loader) * probe_epochs)
            step_losses = None if record is None else record.setdefault("probe_step_losses", [])
            try:
                _, ft["predict"], _ = fit_classifier(
                    model, mc, train_loader, targets, len(classes),
                    lr=one_cycle_lr(1e-4, total_steps), epochs=probe_epochs, modality="image",
                    train_encoder=True, seed=mc.default_seed, step_losses=step_losses)
            finally:
                train_loader.close()
        if split not in ft:
            loader = make_loader(split, image_spec)
            try:
                ft[split] = np.concatenate([ft["predict"](b["image"]).cpu().numpy()
                                            for b in loader.batches(shuffle=False)])
            finally:
                loader.close()
        return ft[split]

    def fuse(seen_split, unseen_split, threshold):
        seen_q, unseen_q = run(seen_split), run(unseen_split)
        seen_q_feats = {"image": seen_q["encoded_image_feature"],
                        "dna": seen_q["encoded_dna_feature"]}
        unseen_q_feats = {"image": unseen_q["encoded_image_feature"],
                          "dna": unseen_q["encoded_dna_feature"]}
        gts = (labels_to_level_arrays(seen_q["label_list"]),
               labels_to_level_arrays(unseen_q["label_list"]))
        unseen_key_kw = (unseen_keys["encoded_dna_feature"],
                         labels_to_level_arrays(unseen_keys["label_list"]))
        if linear and probe == "full":
            classes, species_to_levels = train_species_map()
            class_labels = class_labels_by_level_from_map(classes, species_to_levels)
            side_a = [predictions_from_logits(finetuned_logits(s), class_labels,
                                              common_kw["max_k"])
                      for s in (seen_split, unseen_split)]
            return method_from_classifier(side_a, seen_q_feats, unseen_q_feats, *unseen_key_kw,
                                          *gts, classes, threshold=threshold, **common_kw)
        if linear:
            _, species_to_levels = train_species_map()
            # fit the probe once: the threshold-search pass and the eval pass
            # train on identical inputs
            if "probe" not in ft:
                train = run(train_split)
                ft["probe"] = fit_frozen_probe(
                    train["encoded_image_feature"],
                    np.asarray([lab["species"] for lab in train["label_list"]], dtype=object),
                    probe_steps=probe_steps, device=device,
                    losses=None if record is None else record.setdefault("frozen_probe_losses",
                                                                         []))
            return method_linear(None, None, seen_q_feats, unseen_q_feats, *unseen_key_kw,
                                 *gts, species_to_levels, probe_steps=probe_steps,
                                 threshold=threshold, trained_probe=ft["probe"], **common_kw)
        seen_keys = run("seen_keys")
        return method_nn(seen_q_feats, unseen_q_feats, seen_keys["encoded_image_feature"],
                         labels_to_level_arrays(seen_keys["label_list"]), *unseen_key_kw,
                         *gts, threshold=threshold, **common_kw)

    # the threshold is searched on the VAL queries, then applied to the
    # eval_on split (method_nn.py:318-358); for eval_on == val the second
    # pass would repeat the first
    if eval_on == "val":
        result = fuse("val_seen", "val_unseen", None)
    else:
        val_result = fuse("val_seen", "val_unseen", None)
        result = fuse(f"{eval_on}_seen", f"{eval_on}_unseen", val_result["best_threshold"])
    summary = {
        "best_threshold": result["best_threshold"],
        "seen_species_top1": result["seen"]["micro_acc"][1]["species"],
        "unseen_species_top1": result["unseen"]["micro_acc"][1]["species"],
        # fraction of queries routed to the correct side (the seen/unseen
        # species pools are disjoint) — method_linear_on_INSECT.py:412-425
        "seen_routing_top1": result["seen"]["routing_acc"][1],
        "unseen_routing_top1": result["unseen"]["routing_acc"][1],
    }
    return summary


def clip_towers_from_checkpoint(mc, device: torch.device):
    """The CLIP vision and text towers of `mc.clip`'s widths with the weights
    of the open_clip state dict `mc.clip.checkpoint`, on `device`, and the
    BPE tokenizer of `mc.clip.bpe_path` → (vision, text, tokenizer)."""
    vcfg, tcfg = clip_configs(mc)
    sd = load_torch_state_dict(mc.clip.checkpoint)
    sd.pop("__meta__", None)
    vision_tree, text_tree, _scale = clip_params_from_state_dict(sd, vcfg, tcfg)
    vision, text = CLIPVision(vcfg), CLIPText(tcfg)
    vision.load_state_dict(params_from_jax(vision_tree))
    text.load_state_dict(params_from_jax(text_tree))
    tokenizer = CLIPTokenizer(mc.clip.bpe_path, context_length=mc.clip.context_length)
    return vision.to(device), text.to(device), tokenizer


def clip_encoders(vision: CLIPVision, text: CLIPText, tokenizer,
                  compute_dtype=torch.bfloat16):
    """→ (encode_images(images) → [B, embed] fp32 numpy, encode_text(prompts)
    → [P, embed] fp32 numpy): the CLIP towers without normalisation, on
    their device, in `compute_dtype` (bf16, as the JAX command's)."""
    device = vision.proj.device

    def encode_images(images) -> np.ndarray:
        with torch.inference_mode():
            x = dequantize_image(to_device(images, device))
            return vision(clip_normalize(x), compute_dtype).cpu().numpy()

    def encode_text(prompts) -> np.ndarray:
        with torch.inference_mode():
            ids = torch.from_numpy(np.asarray(tokenizer(prompts))).to(device)
            return text(ids, compute_dtype).cpu().numpy()

    return encode_images, encode_text


def zeroshot_eval(vision: CLIPVision, text: CLIPText, tokenizer, make_loader: Callable,
                  split: str = "test_seen", keys_split: str = "all_keys",
                  level: str = "species", batch_size: int = 64, four_level: bool = False,
                  image_to_image: bool = False) -> Dict:
    """Zero-shot taxonomic classification with prompt ensembles
    (`cmd_zeroshot`): the `split` images through the CLIP vision tower,
    classified against the class prototypes of `level`'s names (or, with
    `four_level`, of the "order family genus species" strings of
    `keys_split`'s species), or (`image_to_image`) retrieved against the
    CLIP-encoded `keys_split` gallery.  → the command's report dict."""
    encode_images, encode_text = clip_encoders(vision, text, tokenizer)
    spec = BatchSpec(batch_size=batch_size, train=False, with_dna=False, with_language=False)

    def images_of(split_name):
        loader = make_loader(split_name, spec)
        try:
            feats = [encode_images(b["image"]) for b in loader.batches(shuffle=False)]
            return np.concatenate(feats), loader.label_dicts()
        finally:
            loader.close()

    image_features, labels = images_of(split)
    gt_by_level = labels_to_level_arrays(labels)

    def per_level_report(preds_by_level, mode):
        micro = top_k_micro_accuracy(preds_by_level, gt_by_level, (1, 3, 5))
        macro, _pc = top_k_macro_accuracy(preds_by_level, gt_by_level, (1, 3, 5))
        return {"mode": mode, "split": split, "micro_acc": micro, "macro_acc": macro}

    if image_to_image:
        # reference inference_and_eval_with_bioclip_with_image_to_image.py
        key_features, key_labels = images_of(keys_split)
        _, idx = knn_search(image_features, key_features, k=5, device=vision.proj.device)
        preds = predictions_to_level_arrays(idx, labels_to_level_arrays(key_labels))
        return per_level_report(preds, "image_to_image")

    if four_level:
        # class prompts are the full "order family genus species" strings
        # (reference ..._with_four_level_text_input.py:103-119); predictions
        # are species and mapped back to their taxon dicts per level
        kloader = make_loader(keys_split, spec)
        species_to_label: dict = {}
        for lab in kloader.label_dicts():
            species_to_label.setdefault(lab["species"], lab)
        kloader.close()
        species = sorted(species_to_label)
        prompts = [taxon_prompt(species_to_label[s]).replace("_", " ") for s in species]
        protos = build_class_prototypes(prompts, encode_text)
        pred_species, _sc = zero_shot_classify(image_features, protos, species, max_k=5)
        preds = {lv: np.asarray([[species_to_label[s][lv] for s in row] for row in pred_species],
                                dtype=object)
                 for lv in LEVELS}
        return per_level_report(preds, "four_level_text")

    class_names = sorted({lab[level] for lab in labels})
    protos = build_class_prototypes(class_names, encode_text)
    preds, _scores = zero_shot_classify(image_features, protos, class_names, max_k=5)
    gt = np.asarray([lab[level] for lab in labels], dtype=object)
    hits = {k: float((preds[:, :k] == gt[:, None]).any(1).mean()) for k in (1, 3, 5)}
    return {"level": level, "top_k_micro_acc": hits, "num_classes": len(class_names)}


BZSL_CSVS = ("dna_embedding_from_bioscan_clip_no_fine_tuned_on_INSECT.csv",
             "image_embedding_from_bioscan_clip_no_fine_tuned_on_INSECT.csv")


def bzsl_extract(model, mc, make_loader: Callable, class_labels: np.ndarray, folder: str,
                 batch_size: int = 200, progress: bool = False) -> tuple:
    """INSECT's "all" split through the image and DNA encoders → the BZSL
    CSVs in `folder` (`cmd_bzsl_extract`): the per-class mean DNA embeddings
    [D, classes] and the image embeddings [D, N] (`data/insect.
    export_bzsl_csvs`); `class_labels` is each record's 0-based class.
    → (dna CSV path, image CSV path)."""
    loader = make_loader("all", BatchSpec(batch_size=batch_size, train=False,
                                          with_language=False))
    try:
        out = extract_split(model, mc, loader, progress=progress)
    finally:
        loader.close()
    os.makedirs(folder, exist_ok=True)
    dna_csv, img_csv = (os.path.join(folder, name) for name in BZSL_CSVS)
    export_bzsl_csvs(out["encoded_dna_feature"], out["encoded_image_feature"], class_labels,
                     dna_csv, img_csv)
    return dna_csv, img_csv
