"""Analysis/plotting one-offs: the port of `clibd_tpu/cli/analysis_cmds.py`
(scripts/result/*, flattenCsv.py).  `flatten-csv`, `plot-embeddings`,
`stats-summary`, `compare-experiments` and `confusion-matrices` are host
commands with no device; `attention-maps` (its probe forward) and
`failure-cases` (its kNN) run on `--device`, the card unless `--device cpu`
is passed."""

from __future__ import annotations

import json
import os

import torch

from .common import _dataset_hdf5_path, _load_cfg, _resolve_params


def cmd_flatten_csv(args, overrides) -> int:
    from ..analysis.tables import flatten_results_csv

    out = flatten_results_csv(args.input, args.out)
    print(f"Wrote {out}")
    return 0


def cmd_plot_embeddings(args, overrides) -> int:
    """Embedding plots from a cached extraction HDF5 (inference_and_eval.py:98-220)."""
    cfg = _load_cfg(args, overrides)
    import json as _json

    import h5py

    from ..analysis.plots import generate_embedding_plot

    with h5py.File(args.features) as f:
        g = f[args.group]
        img = g["encoded_image_feature"][:] if "encoded_image_feature" in g else None
        dna = g["encoded_dna_feature"][:] if "encoded_dna_feature" in g else None
        lang = g["encoded_language_feature"][:] if "encoded_language_feature" in g else None
    with open(args.labels) as f:
        total = _json.load(f)
    key = {"seen": "seen_gt_dict", "unseen": "unseen_gt_dict", "key": "key_gt_dict"}[args.group]
    written = generate_embedding_plot(
        args.out, img, dna, lang, total[key],
        embeddings_filters=dict(cfg.inference_and_eval_setting.embeddings_filters),
        formats=("png", "html"),
    )
    for p in written:
        print(p)
    return 0


def cmd_stats_summary(args, overrides) -> int:
    """Dataset statistics summaries (reference create_statistics_summaries.py)."""
    from ..analysis.statistics import write_statistics_csvs

    paths = write_statistics_csvs(args.hdf5, args.out,
                                  splits=args.splits_list or None)
    for name, p in paths.items():
        print(f"{name}: {p}")
    return 0


def cmd_compare_experiments(args, overrides) -> int:
    """Multi-experiment comparison plots (reference scripts/result/
    comparing_multi_experiment_results_in_same_plot[_all_in_one].py)."""
    from ..analysis.compare import (
        add_harmonic_mean_acc,
        load_experiment_acc_dicts,
        plot_multi_experiment_all_in_one,
        plot_multi_experiment_comparison,
    )

    spec = {}
    for item in args.experiments:
        name, _, path = item.partition("=")
        spec[name] = path or name
    experiments = {n: add_harmonic_mean_acc(a)
                   for n, a in load_experiment_acc_dicts(spec).items()}
    paths = plot_multi_experiment_comparison(
        experiments, args.out, query_type=args.query_type,
        key_type=args.key_type, k=args.k)
    paths.append(plot_multi_experiment_all_in_one(
        experiments, os.path.join(args.out, "compare_all_in_one.png"),
        query_type=args.query_type, key_type=args.key_type, k=args.k))
    if args.poster:
        from ..analysis.compare import plot_poster_accuracy

        for name, acc in experiments.items():
            paths.append(plot_poster_accuracy(
                acc, os.path.join(args.out, f"poster_{name}.pdf"),
                experiment_name=name, k=args.k))
    if args.line_plots:
        from ..analysis.compare import LINE_PLOT_PAIRS, plot_line_plot_pair

        short = {"encoded_image_feature": "image", "encoded_dna_feature": "dna"}
        for q, key in LINE_PLOT_PAIRS:
            p = plot_line_plot_pair(
                experiments, os.path.join(
                    args.out, f"line_plot_{short[q]}_to_{short[key]}.png"),
                query_type=q, key_type=key, k=args.k)
            if p:
                paths.append(p)
    for p in paths:
        print(p)
    return 0


def cmd_confusion_matrices(args, overrides) -> int:
    """Subset confusion-matrix heatmaps (10 most-common / 10 most-confused
    classes per split × query→key pair × taxonomic level) from a cached
    pred_dict_<split>.json written by `clibd eval` (reference
    scripts/result/create_confusion_matrix.py)."""
    from ..analysis.plots import plot_subset_confusion_matrices

    with open(args.pred_json) as f:
        pred_dict = json.load(f)
    paths = plot_subset_confusion_matrices(pred_dict, args.out, top_n=args.top_n)
    for p in paths:
        print(p)
    return 0


def cmd_attention_maps(args, overrides) -> int:
    """Attention-rollout representation visualization (reference
    scripts/result/representation_visualization/)."""
    cfg = _load_cfg(args, overrides)
    import numpy as np

    from ..analysis.attention_maps import (
        attention_rollout,
        bert_attention_probs,
        save_dna_attention_figure,
        save_image_attention_figure,
        top_orders_barcodes,
        vit_attention_probs,
    )
    from ..engine.checkpoint import load_params_any

    mc = cfg.model_config
    hdf5 = args.hdf5 or _dataset_hdf5_path(cfg)
    device = torch.device(args.device)
    model = _resolve_params(cfg, device)
    os.makedirs(args.out, exist_ok=True)
    layer_range = tuple(args.layer_range)
    written = []

    if args.modality in ("image", "both"):
        from ..data.pipeline import BatchSpec, BioscanLoader

        spec = BatchSpec(batch_size=args.n_samples, train=False,
                         with_dna=False, with_language=False)
        loader = BioscanLoader(hdf5, args.split, spec, num_workers=0, limit=args.n_samples)
        batch = next(loader.batches(shuffle=False))
        loader.close()
        images = batch["image"]
        if images.dtype == np.uint8:  # uint8 transport mode
            images = images.astype(np.float32) / 255.0
        else:
            images = np.asarray(images, np.float32)
        rows = {}
        if args.before_ckpt:
            before = load_params_any(args.before_ckpt, mc)
            bp = before.get("image_encoder", before)
            probs = vit_attention_probs(bp, images, mc.image.vit, device=device)
            rows["before alignment"] = attention_rollout(
                probs, args.discard_ratio, args.head_fusion, layer_range=layer_range)
        probs = vit_attention_probs(model.image_encoder, images, mc.image.vit, device=device)
        rows["after alignment"] = attention_rollout(
            probs, args.discard_ratio, args.head_fusion, layer_range=layer_range)
        path = os.path.join(args.out, f"image_attention_{args.split}.png")
        written.append(save_image_attention_figure(path, images, rows))

    if args.modality in ("dna", "both"):
        from ..data.tokenizers import tokenize_dna_batch, tokenize_dna_batch_overlapping

        by_order = top_orders_barcodes(hdf5, args.split, n_orders=args.n_orders,
                                       n_samples=args.n_samples)
        masks = {}
        for order, barcodes in by_order.items():
            if mc.dna.tokenizer == "overlap":
                ids, att = tokenize_dna_batch_overlapping(
                    barcodes, k=mc.dna.kmer, stride=mc.dna.stride, max_bp=mc.dna.max_bp)
                att = att[:, : ids.shape[1]]
            else:
                ids = tokenize_dna_batch(barcodes, k=mc.dna.kmer, max_bp=mc.dna.max_bp)
                att = None
            probs = bert_attention_probs(model.dna_encoder, ids, att, mc.dna.bert, device=device)
            masks[order] = attention_rollout(
                probs, args.discard_ratio, args.head_fusion, layer_range=layer_range)
        path = os.path.join(args.out, f"dna_attention_{args.split}.png")
        written.append(save_dna_attention_figure(path, masks))

    for p in written:
        print(f"wrote {p}")
    return 0


def cmd_failure_cases(args, overrides) -> int:
    """Paired failure-case figures from cached extracted features (reference
    scripts/result/show_paired_failure_cases.py)."""
    from ..analysis.failure_cases import QUERY_AND_KEY_WE_CARE_ABOUT, save_paired_failure_cases
    from ..engine.extract import load_extracted_features

    seen_dict, unseen_dict, keys_dict = load_extracted_features(
        args.features, args.labels, args.ids)
    pairs = QUERY_AND_KEY_WE_CARE_ABOUT
    if args.pairs:
        pairs = [tuple(p.split(":")) for p in args.pairs]
    written = save_paired_failure_cases(
        args.out, args.hdf5, args.seen_split, args.unseen_split, args.keys_split,
        seen_dict, unseen_dict, keys_dict, pairs=pairs, max_cases=args.max_cases,
        device=torch.device(args.device))
    print(f"wrote {len(written)} failure-case figures under {args.out}")
    return 0
