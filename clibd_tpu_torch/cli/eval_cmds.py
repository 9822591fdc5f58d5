"""`eval`: the port of `clibd_tpu/cli/eval_cmds.py::cmd_eval` -- extract
all_keys / {eval_on}_seen / {eval_on}_unseen, write the embedding cache, run
the kNN grid, the retrieval grids (`retrieve_images`) and the similarity
distributions (`similarity_distributions`) where the config asks for them,
print the reference's table and write its reports; with
`--unimodel`, of a SimCLR-pretrained image encoder alone; `zeroshot`
(`cmd_zeroshot`, `:180-298`) and `method-nn` (`cmd_method_nn`, `:299-495`),
thin commands over `engine/downstream.py`; and `verify-parity`
(`cmd_verify_parity`, `eval_cmds.py:496-526`)."""

from __future__ import annotations

import json
import os

import torch

from .common import _dataset_hdf5_path, _extract_split_auto, _load_cfg, _resolve_params


def unimodel_config(cfg, simclr_ckpt: str):
    """Set `cfg` up for `eval --unimodel`, the SimCLR encoder's retrieval
    eval (reference scripts/unimodel/inference_and_eval_with_unimodel.py:
    1-190): an image-only model whose backbone comes from the SimCLR
    checkpoint `simclr_ckpt`, no CLIBD checkpoint loaded, and a cache and
    output folder of its own (`<model_output_name>_unimodel`), so the named
    model's cached embeddings are neither read nor overwritten."""
    mc = cfg.model_config
    mc.dna.enable = False
    mc.language.enable = False
    mc.image.simclr_ckpt_path = simclr_ckpt
    mc.load_ckpt = False
    mc.model_output_name = f"{mc.model_output_name}_unimodel"
    return cfg


def cmd_eval(args, overrides) -> int:
    from ..config import to_dict
    from ..data.pipeline import BatchSpec
    from ..engine.evaluate import format_results, inference_and_eval, save_results, stringify
    from ..engine.extract import load_extracted_features, save_extracted_features, save_labels_and_ids
    from ..utils.profiling import PhaseTimer

    from ..parallel.mesh import all_hosts_agree, is_main_process

    cfg = _load_cfg(args, overrides)
    if getattr(args, "unimodel", None):
        unimodel_config(cfg, args.unimodel)
    settings = cfg.inference_and_eval_setting
    device = torch.device(args.device)
    timing = PhaseTimer(device)  # reported when CLIBD_EVAL_TIMING=1

    mc = cfg.model_config
    eval_on = settings.eval_on
    hdf5 = args.hdf5 or _dataset_hdf5_path(cfg)
    folder = os.path.join(cfg.project_root_path, "extracted_embedding", mc.dataset,
                          mc.model_output_name)
    os.makedirs(folder, exist_ok=True)
    # under torchrun every rank extracts its share and holds the whole
    # split's dicts, but only rank 0 writes files
    main = is_main_process()
    feat_path = os.path.join(folder, f"extracted_feature_from_{eval_on}_split.hdf5")
    labels_path = os.path.join(folder, f"labels_{eval_on}.json")
    ids_path = os.path.join(folder, f"processed_id_{eval_on}.json")

    # the ranks agree on the branch (the extraction below has collectives):
    # only rank 0 writes the cache, so each rank's own disk may not have it
    if all_hosts_agree(cfg.load_inference and
                       all(os.path.exists(p) for p in (feat_path, labels_path, ids_path))):
        print("Loading embeddings from file...")
        with timing.phase("load cached embeddings (I/O)"):
            seen_dict, unseen_dict, keys_dict = load_extracted_features(feat_path, labels_path,
                                                                        ids_path)
    else:
        model = _resolve_params(cfg, device)
        spec = BatchSpec.eval_spec(mc)

        def run(split, for_key=False):
            return _extract_split_auto(model, mc, cfg, hdf5, split, spec, for_key=for_key,
                                       progress=True)

        with timing.phase("extraction (decode+encode)"):
            keys_dict = run("all_keys", for_key=True)
            seen_dict = run(f"{eval_on}_seen")
            unseen_dict = run(f"{eval_on}_unseen")
        if cfg.save_inference and main:
            with timing.phase("write embedding cache (I/O)"):
                save_extracted_features(feat_path, seen_dict, unseen_dict, keys_dict)
                save_labels_and_ids(labels_path, ids_path, seen_dict, unseen_dict, keys_dict)

    k_list = list(settings.k_list)
    with timing.phase("kNN grid + micro/macro metrics"):
        acc_dict, per_class_acc, pred_dict = inference_and_eval(
            keys_dict, seen_dict, unseen_dict, k_list=k_list,
            query_chunk=settings.knn_query_chunk, with_preds=bool(cfg.save_inference and main),
            device=device)

    if settings.retrieve_images and main:
        from ..engine.retrieval_grid import retrieve_images_multi

        rs = settings.retrieve_settings
        pairs = [(q, k) for q in ("encoded_image_feature", "encoded_dna_feature")
                 for k in ("encoded_image_feature", "encoded_dna_feature")
                 if seen_dict.get(q) is not None and keys_dict.get(k) is not None]
        with timing.phase("retrieval image grids"):
            retrieve_images_multi(
                os.path.join(folder, "retrieval"), hdf5, f"{eval_on}_seen", "all_keys",
                seen_dict, keys_dict,
                query_keys=pairs or [("encoded_image_feature", "encoded_image_feature")],
                num_queries=rs.num_queries, max_k=rs.max_k, seed=rs.seed,
                independent=rs.independent, load_cached_results=rs.load_cached_results,
                only_failures=rs.only_failures, device=device)
    if settings.similarity_distributions and main:
        from ..analysis.distributions import (plot_similarity_distributions,
                                              similarity_distribution_rows, write_distance_csv)

        with timing.phase("similarity distributions"):
            rows = similarity_distribution_rows(keys_dict, seen_dict, unseen_dict)
            write_distance_csv(rows, os.path.join(folder, "similarity_distances.csv"))
            plot_similarity_distributions(rows,
                                          os.path.join(folder, "similarity_distributions.png"))
    if settings.plot_embeddings and main:
        from ..analysis.plots import generate_embedding_plot

        with timing.phase("embedding plots"):
            generate_embedding_plot(
                os.path.join(folder, "plots"),
                keys_dict.get("encoded_image_feature"),
                keys_dict.get("encoded_dna_feature"),
                keys_dict.get("encoded_language_feature"),
                keys_dict["label_list"],
                embeddings_filters=dict(settings.embeddings_filters),
                formats=("png", "html"),
            )
    alignment = "I"
    if mc.dna.enable:
        alignment += ",D"
    if mc.language.enable:
        alignment += ",T"
    meta = {
        "learning_strategy": "FineTuning" if mc.disable_lora else "LoRA",
        "dna_encoder": mc.dna.model,
        "image_encoder": mc.image.model,
        "language_encoder": mc.language.model,
        "epochs": mc.epochs,
        "output_dim": mc.output_dim,
    }
    table, csv_rows, raw_rows, copy_rows = format_results(acc_dict, k_list, alignment, meta)
    print(table)
    print("For copy to google doc")
    for row in copy_rows:
        print(row)
    if cfg.save_inference and main:
        with timing.phase("CSV/JSON + HTML report (I/O)"):
            save_results("logs", acc_dict, csv_rows, raw_rows, config_snapshot=to_dict(cfg))
            for name, payload in (
                (f"per_class_acc_{eval_on}.json", per_class_acc),
                (f"acc_dict_{eval_on}.json", acc_dict),
                (f"pred_dict_{eval_on}.json", pred_dict),
            ):
                with open(os.path.join(folder, name), "w") as f:
                    json.dump(stringify(payload), f, indent=4)
            from ..analysis.report import eval_report_sections, write_html_report

            sections = eval_report_sections(folder, acc_table_rows=csv_rows or None)
            write_html_report(os.path.join(folder, "report.html"),
                              f"{mc.model_output_name} — {mc.dataset} ({eval_on})", sections)
    if os.environ.get("CLIBD_EVAL_TIMING"):
        print(timing.report("clibd eval wall-time breakdown"))
    return 0


def _bioscan_loader_factory(cfg, hdf5: str):
    """→ make_loader(split, spec): a `BioscanLoader` over one split of `hdf5`
    with the config's pipeline settings."""
    from ..data.pipeline import BioscanLoader

    def make_loader(split, spec):
        return BioscanLoader(hdf5, split, spec, num_workers=cfg.pipeline.num_workers,
                             use_native=cfg.pipeline.use_native_decoder,
                             seed=cfg.model_config.default_seed)

    return make_loader


def cmd_zeroshot(args, overrides) -> int:
    """CLIP/BioCLIP zero-shot taxonomic classification with prompt ensembles
    (reference scripts/bioclip/inference_and_eval_with_bioclip.py) on the
    port's CLIP towers, loaded from the open_clip state dict
    `model_config.clip.checkpoint`, in bf16 (`engine.downstream.
    zeroshot_eval`)."""
    from ..engine.downstream import clip_towers_from_checkpoint, zeroshot_eval

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    if not mc.clip.checkpoint or not mc.clip.bpe_path:
        raise SystemExit("zeroshot requires model_config.clip.checkpoint and .bpe_path")
    vision, text, tokenizer = clip_towers_from_checkpoint(mc, torch.device(args.device))
    hdf5 = args.hdf5 or _dataset_hdf5_path(cfg)
    report = zeroshot_eval(vision, text, tokenizer, _bioscan_loader_factory(cfg, hdf5),
                           split=args.split, keys_split=args.keys_split, level=args.level,
                           batch_size=args.batch_size, four_level=args.four_level,
                           image_to_image=args.image_to_image)
    print(json.dumps(report, default=str))
    return 0


def cmd_method_nn(args, overrides) -> int:
    """Seen/unseen threshold-fusion eval (reference scripts/method_nn.py;
    with --linear, scripts/method_linear.py, and --probe full its fine-tuned
    image classifier) through `engine.downstream.method_nn_eval`; prints the
    summary JSON."""
    from ..engine.downstream import method_nn_eval
    from ..engine.evaluate import stringify

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    model = _resolve_params(cfg, torch.device(args.device))
    hdf5 = args.hdf5 or _dataset_hdf5_path(cfg)
    settings = cfg.inference_and_eval_setting
    summary = method_nn_eval(
        model, mc, _bioscan_loader_factory(cfg, hdf5), eval_on=settings.eval_on,
        k_list=list(settings.k_list), unseen_keys_split=args.unseen_keys_split,
        side_b_query=args.side_b_query, linear=args.linear, probe=args.probe,
        probe_steps=args.probe_steps, probe_epochs=args.probe_epochs,
        train_split=args.train_split, progress=True)
    print(json.dumps(stringify(summary)))
    return 0


def cmd_verify_parity(args, overrides) -> int:
    """Released-artifact parity harness (RELEASE_PARITY.md runbook;
    reference README.md:29-44 artifacts, BASELINE.md 0.5% criterion) on
    `--device`."""
    from ..engine.verify_parity import format_report, save_report, verify_parity

    cfg = _load_cfg(args, overrides)
    expected = None
    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f)
    report = verify_parity(
        cfg.model_config,
        ckpt=args.ckpt,
        released_embeddings=args.released_embeddings,
        released_labels=args.released_labels,
        released_ids=args.released_ids,
        hdf5=args.hdf5 or (_dataset_hdf5_path(cfg) if args.ckpt else None),
        n=args.n if args.n and args.n > 0 else None,
        eval_on=cfg.inference_and_eval_setting.eval_on,
        tokenizer_file=args.tokenizer,
        expected=expected,
        cos_threshold=args.cos_threshold,
        top1_threshold=args.top1_threshold,
        num_workers=cfg.pipeline.num_workers,
        use_native=cfg.pipeline.use_native_decoder,
        device=torch.device(args.device),
    )
    print(format_report(report))
    if args.out:
        save_report(report, args.out)
        print(f"report written to {args.out}")
    return 0 if report["ok"] else 1
