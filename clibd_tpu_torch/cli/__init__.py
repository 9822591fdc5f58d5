"""Command line of the port (`python -m clibd_tpu_torch.cli`):

  train          --experiment <cfg.yaml> [--hdf5 data.hdf5] [--output-dir DIR]
                 [--train-split SPLIT] [--resume [DIR]] [--device cuda] [k=v ...]
  eval           --experiment <cfg.yaml> [--hdf5 data.hdf5] [--unimodel SIMCLR_CKPT]
                 [--device cuda] [k=v ...]
  simclr         --experiment <cfg.yaml> [--hdf5 data.hdf5] [--output-dir DIR]
                 [--train-split SPLIT] [--temperature 0.07] [--device cuda] [k=v ...]
  extract        --experiment <cfg.yaml> [--split all_keys] [--out emb.hdf5]
                 [--stream [--resume]] [--device cuda] [k=v ...]
  extract-single --experiment <cfg.yaml> [--image img.jpg] [--barcode ACGT...]
                 [--out emb.json] [--device cuda] [k=v ...]
  serve          --experiment <cfg.yaml> [--keys gallery.hdf5] [--port 8000]
                 [--window-ms 4] [--max-batch 32] [--keys-dtype int8] ...
                 [--device cuda] [k=v ...]
  verify-parity  --experiment <cfg.yaml> [--ckpt best.pth] [--hdf5 data.hdf5]
                 [--released-embeddings emb.hdf5] [--n 2000] [--tokenizer FILE]
                 ... [--device cuda] [k=v ...]
  finetune       --experiment <INSECT cfg.yaml> [--modality image|dna] [--epochs 15]
                 [--lr 1e-4] [--freeze-encoder] [--output-dir DIR] [--device cuda] [k=v ...]
  bzsl-extract   --experiment <INSECT cfg.yaml> [--batch-size 200] [--device cuda] [k=v ...]
  method-nn      --experiment <cfg.yaml> [--hdf5 data.hdf5] [--unseen-keys-split unseen_keys]
                 [--side-b-query image|dna] [--linear [--probe frozen|full]
                 [--probe-steps 500] [--probe-epochs 5] [--train-split seen_keys]]
                 [--device cuda] [k=v ...]
  zeroshot       --experiment <open_clip cfg.yaml> [--hdf5 data.hdf5] [--split test_seen]
                 [--level species | --four-level | --image-to-image] [--keys-split all_keys]
                 [--batch-size 64] [--device cuda] [k=v ...]
  attention-maps --experiment <cfg.yaml> [--hdf5 data.hdf5] [--modality image|dna|both]
                 [--split test_seen] [--out DIR] [--n-samples 8] [--n-orders 5]
                 [--before-ckpt CKPT] [--discard-ratio 0.9] [--head-fusion max|mean|min]
                 [--layer-range 1 -6] [--device cuda] [k=v ...]
  failure-cases  --features emb.hdf5 --labels labels.json --ids ids.json --hdf5 data.hdf5
                 [--out DIR] [--seen-split ...] [--max-cases 10] [--pairs q:k ...]
                 [--device cuda]
  doctor         [--experiment <cfg.yaml>] [--hdf5 data.hdf5] [--timeout 30]
                 [--build-native] [--device cuda] [k=v ...]
  bench          [--device cuda]
  create-splits  --metadata meta.tsv [--out splits.tsv] [--min-species-size 10]
                 [--seen-ratio 0.8] [--seed N]
  build-hdf5     --metadata meta.tsv --image-dir DIR --out data.hdf5 [--splits splits.tsv]
                 [--vocab vocab.txt] [--compress] [--parallel [--processes N]
                 [--chunk-size 4096] [--resume]]
  subset-hdf5    --hdf5 data.hdf5 --out sub.hdf5 (--ratio R [--split ...] | --sizes split=n ...)
                 [--seed 42] [--no-other-splits]
  generate-split-csv --hdf5 data.hdf5 --out splits.csv [--splits-list SPLIT ...]
  fetch-taxonomy --out taxo.json --email ADDR (--species NAME ... | --res101-mat res101.mat)
  flatten-csv    --input results.csv [--out flat.csv]
  plot-embeddings --experiment <cfg.yaml> --features emb.hdf5 --labels labels.json
                 [--group seen|unseen|key] [--out DIR] [k=v ...]
  stats-summary  --hdf5 data.hdf5 --out DIR [--splits-list SPLIT ...]
  compare-experiments name=accuracy.json ... --out DIR [--query-type ...] [--key-type ...]
                 [--k 1] [--poster] [--line-plots]
  confusion-matrices --pred-json pred_dict.json [--out DIR] [--top-n 10]
  configs

the counterparts of the JAX package's 26 subcommands (`clibd <command>`).
`eval`, `extract`, `extract-single`, `serve`, `finetune`, `bzsl-extract`
and `method-nn` take a released `best.pth` as `model_config.ckpt_path=<file>`;
`zeroshot` reads an open_clip state dict (`model_config.clip.checkpoint`)
and a BPE merges file (`model_config.clip.bpe_path`).  Every command that
touches a device runs on the card; `--device cpu` runs it on the CPU (the
kernels' plain versions), and only when asked.  The data commands
(`create-splits`, `build-hdf5`, `subset-hdf5`, `generate-split-csv`,
`fetch-taxonomy`), the analysis commands without a model (`flatten-csv`,
`plot-embeddings`, `stats-summary`, `compare-experiments`,
`confusion-matrices`) and `configs` run on the host: they take no
`--device` and never initialise CUDA.

Under torchrun (`torchrun --nproc_per_node=N -m clibd_tpu_torch.cli
train|simclr|eval|extract ...`) each process is one rank on one card (NCCL;
gloo with `--device cpu`): the group starts before the device is first
used, and is destroyed when the command returns.  `doctor` starts the group
inside its bounded probe instead, and the host commands start none.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .analysis_cmds import (cmd_attention_maps, cmd_compare_experiments, cmd_confusion_matrices,
                            cmd_failure_cases, cmd_flatten_csv, cmd_plot_embeddings,
                            cmd_stats_summary)
from .data_cmds import (cmd_build_hdf5, cmd_create_splits, cmd_fetch_taxonomy,
                        cmd_generate_split_csv, cmd_subset_hdf5)
from .eval_cmds import cmd_eval, cmd_method_nn, cmd_verify_parity, cmd_zeroshot
from .extract_cmds import cmd_bzsl_extract, cmd_extract, cmd_extract_single
from .ops_cmds import cmd_bench, cmd_configs, cmd_doctor, cmd_serve
from .train_cmds import cmd_finetune, cmd_simclr, cmd_train


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu only when asked)")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="clibd_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, device=True):
        p.add_argument("--experiment", "-e", default=None, help="experiment config name or path")
        p.add_argument("--global-config", "-g", default=None)
        p.add_argument("--hdf5", default=None, help="override dataset HDF5 path")
        if device:
            _device_arg(p)
        p.add_argument("overrides", nargs="*", help="key.path=value overrides")

    p_train = sub.add_parser("train", help="contrastive training (train_cl.py)")
    common(p_train)
    p_train.add_argument("--output-dir", default=None)
    p_train.add_argument("--train-split", default="no_split_and_seen_train")
    p_train.add_argument("--resume", nargs="?", const=True, default=None,
                         help="resume from checkpoint dir (default: <output>/last)")
    p_eval = sub.add_parser("eval", help="extract + retrieval eval (inference_and_eval.py)")
    common(p_eval)
    p_eval.add_argument("--unimodel", default=None, metavar="SIMCLR_CKPT",
                        help="evaluate a SimCLR-pretrained image encoder alone "
                             "(unimodel/inference_and_eval_with_unimodel.py)")

    p_simclr = sub.add_parser("simclr", help="SimCLR image pretraining (unimodel/)")
    common(p_simclr)
    p_simclr.add_argument("--output-dir", default=None)
    p_simclr.add_argument("--train-split", default="no_split_and_seen_train")
    p_simclr.add_argument("--temperature", type=float, default=0.07)

    p_extract = sub.add_parser("extract", help="embedding export (save_embedding/)")
    common(p_extract)
    p_extract.add_argument("--split", default="all_keys")
    p_extract.add_argument("--out", default="embeddings.hdf5")
    p_extract.add_argument("--stream", action="store_true",
                           help="append per batch (resizable HDF5, for exports that do not "
                                "fit in host memory)")
    p_extract.add_argument("--resume", action="store_true",
                           help="with --stream: continue a partial output (bit-identical to "
                                "an uninterrupted run)")

    p_single = sub.add_parser(
        "extract-single", help="embed one image/barcode (save_embedding/extract_single_image.py)")
    common(p_single)
    p_single.add_argument("--image", default=None)
    p_single.add_argument("--barcode", default=None)
    p_single.add_argument("--out", default=None)

    p_serve = sub.add_parser("serve", help="resident HTTP inference server (micro-batched "
                                           "embed + top-k search)")
    common(p_serve)
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.add_argument("--keys", default=None,
                         help="save_embedding_export HDF5 gallery for /search")
    p_serve.add_argument("--window-ms", type=float, default=4.0,
                         help="micro-batch coalescing window")
    p_serve.add_argument("--max-batch", type=int, default=32)
    p_serve.add_argument("--no-warm", action="store_true",
                         help="skip running every (modality, bucket) forward at startup")
    p_serve.add_argument("--shard-keys", action="store_true",
                         help="shard the gallery's rows over the local devices of --device's "
                              "type")
    p_serve.add_argument("--keys-dtype", default="float32", choices=("float32", "int8"),
                         help="int8: 4x smaller gallery on the card (approximate scores)")
    p_serve.add_argument("--keys-rerank", type=int, default=4,
                         help="oversample factor of the exact host re-rank against the "
                              "original fp32 rows; on for int8 galleries and for fp32 under "
                              "--keys-selector approx (0 = trust the card's ranks, no host "
                              "fp32 copy)")
    p_serve.add_argument("--keys-selector", default="auto", choices=("auto", "exact", "approx"),
                         help="candidate selection policy, as in the JAX package: auto = "
                              "approx for int8 galleries with a re-rank, exact otherwise "
                              "(approx selects exactly on the card)")
    p_serve.add_argument("--reload-watch", type=float, default=0.0, metavar="SECONDS",
                         help="poll the --keys file and hot-reload the gallery when it "
                              "changes (stable across two polls); 0 = off")
    p_serve.add_argument("--language-vocab", default=None,
                         help="WordPiece vocab.txt enabling taxonomy-text queries")
    p_serve.add_argument("--max-queue", type=int, default=1024,
                         help="shed load (503) beyond this request backlog")

    p_vp = sub.add_parser(
        "verify-parity",
        help="released-artifact parity harness (convert → re-extract → compare; RELEASE_PARITY.md)")
    common(p_vp)
    p_vp.add_argument("--ckpt", default=None, help="released best.pth (or our .npz)")
    p_vp.add_argument("--released-embeddings", default=None,
                      help="released extracted_feature_from_*_split.hdf5")
    p_vp.add_argument("--released-labels", default=None,
                      help="labels_*.json sidecar (default: sibling of the embeddings file)")
    p_vp.add_argument("--released-ids", default=None,
                      help="processed_id_*.json sidecar (default: sibling)")
    p_vp.add_argument("--n", type=int, default=2000,
                      help="records per split to re-extract (None/0 = all)")
    p_vp.add_argument("--tokenizer", default=None,
                      help="vendored BarcodeBERT tokenizer.json or snapshot dir")
    p_vp.add_argument("--expected", default=None,
                      help="JSON of expected species top-1 per grid cell (paper table)")
    p_vp.add_argument("--cos-threshold", type=float, default=0.99)
    p_vp.add_argument("--top1-threshold", type=float, default=0.005)
    p_vp.add_argument("--out", default=None, help="write the JSON report here")

    p_bzsl = sub.add_parser("bzsl-extract", help="INSECT feature → BZSL CSVs (scripts/BZSL/)")
    common(p_bzsl)
    p_bzsl.add_argument("--batch-size", type=int, default=200)

    p_ft = sub.add_parser("finetune", help="supervised fine-tune on INSECT "
                                           "(scripts/BZSL/fine_tune_*.py)")
    common(p_ft)
    p_ft.add_argument("--modality", choices=["image", "dna"], default="image")
    p_ft.add_argument("--epochs", type=int, default=15)
    p_ft.add_argument("--lr", type=float, default=1e-4)
    p_ft.add_argument("--freeze-encoder", action="store_true")
    p_ft.add_argument("--output-dir", default=None)

    p_mnn = sub.add_parser("method-nn", help="seen/unseen threshold fusion (scripts/method_nn.py)")
    common(p_mnn)
    p_mnn.add_argument("--unseen-keys-split", default="unseen_keys",
                       help="comma-separated splits concatenated into the unseen key set (the "
                            "reference pools val_unseen_keys,test_unseen_keys — the "
                            "unseen_keys group is that union)")
    p_mnn.add_argument("--side-b-query", default="image", choices=("image", "dna"),
                       help="query modality for the unseen-DNA-key search; the reference uses "
                            "the image query on both sides (cross-modal side B)")
    p_mnn.add_argument("--linear", action="store_true",
                       help="method_linear variant: side A = linear probe over image features "
                            "(scripts/method_linear.py)")
    p_mnn.add_argument("--probe-steps", type=int, default=500)
    p_mnn.add_argument("--probe", default="frozen", choices=("frozen", "full"),
                       help="frozen: linear probe on extracted features; full: fine-tune the "
                            "whole image encoder + head (reference method_linear.py:458-490)")
    p_mnn.add_argument("--probe-epochs", type=int, default=5,
                       help="epochs for --probe full fine-tuning")
    p_mnn.add_argument("--train-split", default="seen_keys",
                       help="split whose image features train the probe (must cover every "
                            "seen species)")

    p_zs = sub.add_parser("zeroshot", help="CLIP/BioCLIP zero-shot eval (scripts/bioclip/)")
    common(p_zs)
    p_zs.add_argument("--split", default="test_seen")
    p_zs.add_argument("--level", default="species")
    p_zs.add_argument("--batch-size", type=int, default=64)
    p_zs.add_argument("--image-to-image", action="store_true",
                      help="retrieve against the CLIP-encoded image gallery instead of text "
                           "prototypes (..._with_image_to_image.py)")
    p_zs.add_argument("--four-level", action="store_true",
                      help="class prompts are 'order family genus species' strings "
                           "(..._with_four_level_text_input.py)")
    p_zs.add_argument("--keys-split", default="all_keys")

    p_doc = sub.add_parser("doctor", help="deployment diagnostic: device reachability "
                                          "(bounded), native decoder, config/dataset/checkpoint "
                                          "resolution")
    common(p_doc)
    p_doc.add_argument("--timeout", type=float, default=30.0,
                       help="seconds before declaring the device unreachable")
    p_doc.add_argument("--build-native", action="store_true",
                       help="attempt to build the native decoder if missing")

    p_am = sub.add_parser("attention-maps",
                          help="attention-rollout visualization (representation_visualization/)")
    common(p_am)
    p_am.add_argument("--modality", choices=["image", "dna", "both"], default="image")
    p_am.add_argument("--split", default="test_seen")
    p_am.add_argument("--out", default="attention_maps")
    p_am.add_argument("--n-samples", type=int, default=8)
    p_am.add_argument("--n-orders", type=int, default=5)
    p_am.add_argument("--before-ckpt", default=None,
                      help="unaligned encoder checkpoint for the 'before' row")
    p_am.add_argument("--discard-ratio", type=float, default=0.9)
    p_am.add_argument("--head-fusion", choices=["max", "mean", "min"], default="max")
    p_am.add_argument("--layer-range", type=int, nargs=2, default=[1, -6],
                      help="rollout layer window (reference attentions[1:-6])")

    p_fc = sub.add_parser("failure-cases",
                          help="paired GT-vs-top1 failure figures (show_paired_failure_cases.py)")
    p_fc.add_argument("--features", required=True, help="extracted_feature_*.hdf5")
    p_fc.add_argument("--labels", required=True, help="labels_*.json")
    p_fc.add_argument("--ids", required=True, help="processed_id_*.json")
    p_fc.add_argument("--hdf5", required=True, help="dataset HDF5 (for the images)")
    p_fc.add_argument("--out", default="failure_cases")
    p_fc.add_argument("--seen-split", default="test_seen")
    p_fc.add_argument("--unseen-split", default="test_unseen")
    p_fc.add_argument("--keys-split", default="all_keys")
    p_fc.add_argument("--max-cases", type=int, default=10)
    p_fc.add_argument("--pairs", nargs="*", default=None,
                      help="query:key feature-type pairs (default: image→image, dna→dna, "
                           "image→dna)")
    _device_arg(p_fc)
    p_fc.set_defaults(overrides=[])

    p_bench = sub.add_parser("bench", help="image+DNA embedding throughput of the flagship "
                                           "(tools/bench.py)")
    _device_arg(p_bench)
    p_bench.set_defaults(overrides=[])

    # host commands: no --device, no CUDA
    p_splits = sub.add_parser("create-splits",
                              help="BIOSCAN split creation (dataset/create_splits.py)")
    p_splits.add_argument("--metadata", required=True)
    p_splits.add_argument("--out", default="splits.tsv")
    p_splits.add_argument("--min-species-size", type=int, default=10)
    p_splits.add_argument("--seen-ratio", type=float, default=0.8)
    p_splits.add_argument("--seed", type=int, default=None)
    p_splits.set_defaults(overrides=[])

    p_build = sub.add_parser("build-hdf5", help="build split HDF5 (data_processing/)")
    p_build.add_argument("--metadata", required=True)
    p_build.add_argument("--splits", default=None)
    p_build.add_argument("--image-dir", required=True)
    p_build.add_argument("--out", required=True)
    p_build.add_argument("--vocab", default=None,
                         help="vocab.txt for language token pre-tokenization")
    p_build.add_argument("--compress", action="store_true")
    p_build.add_argument("--parallel", action="store_true",
                         help="5M-scale builder: multiprocessing ingestion, chunked resumable "
                              "writes")
    p_build.add_argument("--chunk-size", type=int, default=4096)
    p_build.add_argument("--processes", type=int, default=None)
    p_build.add_argument("--resume", action="store_true",
                         help="continue an interrupted --parallel build")
    p_build.set_defaults(overrides=[])

    p_sub = sub.add_parser("subset-hdf5",
                           help="stratified 1/N pretrain subset or per-split-count subset "
                                "(create_special_pre_train_for_bioscan_5m.py)")
    p_sub.add_argument("--hdf5", required=True)
    p_sub.add_argument("--out", required=True)
    p_sub.add_argument("--ratio", type=float, default=None,
                       help="per-species stratified keep ratio (>=1 record per species)")
    p_sub.add_argument("--split", default="no_split_and_seen_train")
    p_sub.add_argument("--sizes", nargs="*", default=None,
                       help="split=count pairs (plain subset)")
    p_sub.add_argument("--seed", type=int, default=42)
    p_sub.add_argument("--no-other-splits", action="store_true")
    p_sub.set_defaults(overrides=[])

    p_gsc = sub.add_parser("generate-split-csv",
                           help="per-record metadata CSV across splits "
                                "(generate_split_csv_from_the_hdf5.py)")
    p_gsc.add_argument("--hdf5", required=True)
    p_gsc.add_argument("--out", required=True)
    p_gsc.add_argument("--splits-list", nargs="*", default=None)
    p_gsc.set_defaults(overrides=[])

    p_tax = sub.add_parser("fetch-taxonomy",
                           help="NCBI-Entrez species taxonomy fetch (data/INSECT/)")
    p_tax.add_argument("--out", required=True)
    p_tax.add_argument("--email", required=True, help="NCBI requires a contact email")
    p_tax.add_argument("--species", nargs="*", default=None)
    p_tax.add_argument("--res101-mat", default=None,
                       help="INSECT res101.mat to read species from")
    p_tax.set_defaults(overrides=[])

    p_flat = sub.add_parser("flatten-csv", help="flatten results.csv (scripts/flattenCsv.py)")
    p_flat.add_argument("--input", required=True)
    p_flat.add_argument("--out", default="flat.csv")
    p_flat.set_defaults(overrides=[])

    p_plot = sub.add_parser("plot-embeddings", help="2D embedding plots from cached features")
    common(p_plot, device=False)
    p_plot.add_argument("--features", required=True, help="extracted_feature_*.hdf5")
    p_plot.add_argument("--labels", required=True, help="labels_*.json")
    p_plot.add_argument("--group", default="key", choices=["seen", "unseen", "key"])
    p_plot.add_argument("--out", default="plots")

    p_stats = sub.add_parser("stats-summary",
                             help="dataset statistics summaries (create_statistics_summaries.py)")
    p_stats.add_argument("--hdf5", required=True)
    p_stats.add_argument("--out", required=True)
    p_stats.add_argument("--splits-list", nargs="*", default=None)
    p_stats.set_defaults(overrides=[])

    p_cmx = sub.add_parser("confusion-matrices",
                           help="most-common/most-confused class heatmaps from a cached "
                                "pred_dict JSON (create_confusion_matrix.py)")
    p_cmx.add_argument("--pred-json", required=True,
                       help="pred_dict_<split>.json written by `eval`")
    p_cmx.add_argument("--out", default="confusion_matrix")
    p_cmx.add_argument("--top-n", type=int, default=10)
    p_cmx.set_defaults(overrides=[])

    p_cmp = sub.add_parser("compare-experiments",
                           help="multi-experiment comparison plots (scripts/result/)")
    p_cmp.add_argument("experiments", nargs="+", help="name=accuracy.json pairs")
    p_cmp.add_argument("--out", required=True)
    p_cmp.add_argument("--query-type", default="encoded_image_feature")
    p_cmp.add_argument("--key-type", default="encoded_image_feature")
    p_cmp.add_argument("--k", type=int, default=1)
    p_cmp.add_argument("--poster", action="store_true",
                       help="also write one poster-style per-level figure per experiment "
                            "(plot_for_5m_poster.py)")
    p_cmp.add_argument("--line-plots", action="store_true",
                       help="also write the paper-figure line plots (one per dna→dna / "
                            "image→dna / image→image pair, seen solid / unseen dashed; "
                            "scripts/result/plots/)")
    p_cmp.set_defaults(overrides=[])

    sub.add_parser("configs", help="list bundled experiment configs").set_defaults(overrides=[])

    args = parser.parse_args(argv)
    device = getattr(args, "device", None)
    if device is None or args.command == "doctor":
        # host commands start no group and touch no device; `doctor` runs
        # the rendezvous inside its bounded probe, so that a hang is reported
        # rather than suffered
        return _dispatch(args)
    # the rendezvous comes before any use of the device (the reference's
    # ddp_setup, train_cl.py:44-48); a no-op outside torchrun
    from ..parallel.mesh import maybe_initialize_distributed

    distributed = maybe_initialize_distributed(device)
    try:
        return _dispatch(args)
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _dispatch(args) -> int:
    return {
        "train": cmd_train, "eval": cmd_eval, "simclr": cmd_simclr, "extract": cmd_extract,
        "extract-single": cmd_extract_single, "serve": cmd_serve,
        "verify-parity": cmd_verify_parity, "finetune": cmd_finetune,
        "bzsl-extract": cmd_bzsl_extract, "method-nn": cmd_method_nn, "zeroshot": cmd_zeroshot,
        "doctor": cmd_doctor, "attention-maps": cmd_attention_maps,
        "failure-cases": cmd_failure_cases, "bench": cmd_bench,
        "create-splits": cmd_create_splits, "build-hdf5": cmd_build_hdf5,
        "subset-hdf5": cmd_subset_hdf5, "generate-split-csv": cmd_generate_split_csv,
        "fetch-taxonomy": cmd_fetch_taxonomy, "flatten-csv": cmd_flatten_csv,
        "plot-embeddings": cmd_plot_embeddings, "stats-summary": cmd_stats_summary,
        "compare-experiments": cmd_compare_experiments,
        "confusion-matrices": cmd_confusion_matrices, "configs": cmd_configs,
    }[args.command](args, args.overrides)
