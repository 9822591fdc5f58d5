"""`extract`, `extract-single` and `bzsl-extract`: the port of
`clibd_tpu/cli/extract_cmds.py` (`cmd_extract`, `cmd_extract_single`;
reference scripts/save_embedding/; `cmd_bzsl_extract`, reference
scripts/BZSL/), on one device, the card unless `--device cpu` is passed.
Under torchrun `extract` shards the split over the ranks and rank 0 writes
the file."""

from __future__ import annotations

import json
import os

import torch

from .common import _dataset_hdf5_path, _extract_split_auto, _load_cfg, _resolve_params


def cmd_extract(args, overrides) -> int:
    """Embedding export of one split (reference extract_embedding.py); with
    --stream each batch is appended to the file, and --resume continues a
    killed run bit-identically (`engine.extract.stream_extract_split`)."""
    from ..data.pipeline import BatchSpec, BioscanLoader
    from ..engine.extract import save_embedding_export, stream_extract_split
    from ..parallel.mesh import is_main_process, num_hosts

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    model = _resolve_params(cfg, torch.device(args.device))
    hdf5 = args.hdf5 or _dataset_hdf5_path(cfg)
    spec = BatchSpec.eval_spec(mc)
    if args.stream:
        if num_hosts() > 1:
            raise SystemExit("extract --stream appends one process's batches: run it as one "
                             "process, not under torchrun")
        loader = BioscanLoader(hdf5, args.split, spec, num_workers=cfg.pipeline.num_workers,
                               use_native=cfg.pipeline.use_native_decoder)
        try:
            written = stream_extract_split(model, mc, loader, args.out, resume=args.resume,
                                           progress=True)
        finally:
            loader.close()
        print(f"Streamed {written} embeddings for split {args.split!r} to {args.out}")
        return 0
    out = _extract_split_auto(model, mc, cfg, hdf5, args.split, spec, progress=True)
    if is_main_process():
        save_embedding_export(args.out, out)
        print(f"Saved embeddings for split {args.split!r} to {args.out}")
    return 0


def cmd_extract_single(args, overrides) -> int:
    """Embed one image file and/or one DNA barcode string (reference
    extract_single_image.py / extract_embedding_for_single_image.py), with
    the checkpoint's own eval transform and DNA tokenizer."""
    from ..data.pipeline import preprocess_single_image, tokenize_single_barcode
    from ..engine.extract import to_device
    from ..models.clibd import clibd_apply

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    device = torch.device(args.device)
    model = _resolve_params(cfg, device)
    image_input = dna_input = None
    if args.image:
        with open(args.image, "rb") as f:
            image_input = to_device(preprocess_single_image(mc, f.read())[None], device)
    if args.barcode:
        tok = tokenize_single_barcode(mc, args.barcode)
        tok = {k: v[None] for k, v in tok.items()} if isinstance(tok, dict) else tok[None]
        dna_input = to_device(tok, device)
    with torch.inference_mode():
        out = clibd_apply(model, mc, image_input=image_input, dna_input=dna_input)
    result = {}
    if out["image"] is not None:
        result["image_embedding"] = out["image"][0].cpu().tolist()
    if out["dna"] is not None:
        result["dna_embedding"] = out["dna"][0].cpu().tolist()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
        print(f"Wrote {args.out}")
    else:
        print(json.dumps({k: v[:8] for k, v in result.items()}))
    return 0


def cmd_bzsl_extract(args, overrides) -> int:
    """INSECT feature extraction → BZSL CSVs (scripts/BZSL/
    extract_feature_for_insect_dataset.py): every record of INSECT through
    the image and DNA encoders (`engine.downstream.bzsl_extract`); prints the
    two CSV paths."""
    import scipy.io as sio

    from ..data.insect import INSECTLoader
    from ..engine.downstream import bzsl_extract
    from .train_cmds import insect_dataset

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    model = _resolve_params(cfg, torch.device(args.device))
    res = sio.loadmat(cfg.insect_data.path_to_res_101_mat)
    class_labels = res["labels"].squeeze() - 1
    folder = os.path.join(cfg.project_root_path, "extracted_embedding", "INSECT",
                          mc.model_output_name, "trained_on_BIOSCAN_1M")
    dna_csv, img_csv = bzsl_extract(
        model, mc, lambda split, spec: INSECTLoader(insect_dataset(cfg, split), spec),
        class_labels, folder, batch_size=args.batch_size, progress=True)
    print(dna_csv)
    print(img_csv)
    return 0
