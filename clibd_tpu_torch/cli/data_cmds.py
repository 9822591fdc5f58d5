"""Dataset tooling: the port of `clibd_tpu/cli/data_cmds.py` -- split
creation, HDF5 builders, subsets, split CSVs, NCBI taxonomy fetch
(dataset/ + data_processing/), over the port's copies of the JAX package's
data modules.  Host commands: they take no `--device` and never initialise
CUDA."""

from __future__ import annotations

import sys


def cmd_create_splits(args, overrides) -> int:
    """BIOSCAN split creation (reference dataset/create_splits.py)."""
    import pandas as pd

    from ..data.splits import create_splits

    metadata = pd.read_csv(args.metadata, sep="\t")
    out = create_splits(
        metadata,
        min_species_size=args.min_species_size,
        seen_ratio=args.seen_ratio,
        seed=args.seed,
    )
    out.to_csv(args.out, sep="\t")
    print(out["split"].value_counts())
    return 0


def cmd_build_hdf5(args, overrides) -> int:
    """Build split HDF5 from metadata + split TSVs + an image directory."""
    import pandas as pd

    from ..data.builders import REFERENCE_SPLIT_NAME_MAP, build_split_hdf5
    from ..data.tokenizers import WordPieceTokenizer

    metadata = pd.read_csv(args.metadata, sep="\t")
    if args.splits:
        splits = pd.read_csv(args.splits, sep="\t")[["sampleid", "split"]]
        metadata = metadata.merge(splits, on="sampleid", how="inner")
    tokenizer = WordPieceTokenizer(args.vocab) if args.vocab else None
    if args.parallel:
        # 5M-scale path (reference generate_hdf5_file_5m.py): multiprocessing
        # image ingestion, chunked resizable writes, resume support
        from ..data.builders_5m import build_split_hdf5_parallel

        stats = build_split_hdf5_parallel(
            args.out, metadata, args.image_dir,
            tokenizer=tokenizer, split_name_map=REFERENCE_SPLIT_NAME_MAP,
            compression="gzip" if args.compress else None,
            chunk_size=args.chunk_size, num_processes=args.processes,
            resume=args.resume,
        )
        print(f"Wrote {args.out}: {stats}")
        return 0
    build_split_hdf5(
        args.out, metadata, args.image_dir,
        tokenizer=tokenizer, split_name_map=REFERENCE_SPLIT_NAME_MAP,
        compression="gzip" if args.compress else None,
    )
    print(f"Wrote {args.out}")
    return 0


def cmd_subset_hdf5(args, overrides) -> int:
    """Smaller-HDF5 builders: per-species stratified pretrain subset
    (create_special_pre_train_for_bioscan_5m.py) or plain per-split counts."""
    from ..data.subset import subset_hdf5, subset_hdf5_stratified

    if args.ratio is not None:
        n = subset_hdf5_stratified(args.hdf5, args.out, split=args.split,
                                   ratio=args.ratio, seed=args.seed,
                                   copy_other_splits=not args.no_other_splits)
        print(f"kept {n} stratified records of split {args.split!r} → {args.out}")
        return 0
    sizes = {}
    for item in args.sizes or []:
        split, sep, count = item.partition("=")
        if not sep or not count.isdigit():
            raise SystemExit(f"--sizes items must be split=count, got {item!r}")
        sizes[split] = int(count)
    if not sizes:
        raise SystemExit("pass --ratio R (stratified) or split=count pairs via --sizes")
    subset_hdf5(args.hdf5, args.out, sizes, seed=args.seed)
    print(f"subset written → {args.out}")
    return 0


def cmd_generate_split_csv(args, overrides) -> int:
    """Per-record metadata CSV across all splits (reference
    scripts/data_processing/generate_split_csv_from_the_hdf5.py)."""
    from ..data.splits import export_split_csv

    n = export_split_csv(args.hdf5, args.out, splits=args.splits_list or None)
    print(f"wrote {n} rows to {args.out}")
    return 0


def cmd_fetch_taxonomy(args, overrides) -> int:
    """NCBI-Entrez species -> order/family/genus JSON (reference
    data/INSECT/get_all_species_taxo_labels_dict_and_save_to_json.py).
    Needs outbound HTTPS; resumable via the output JSON."""
    from ..data.ncbi import fetch_species_taxonomy_json, species_from_insect_mats

    if args.species:
        species = args.species
    elif args.res101_mat:
        species = species_from_insect_mats(args.res101_mat)
    else:
        print("pass --species ... or --res101-mat", file=sys.stderr)
        return 2
    fetch_species_taxonomy_json(species, args.out, email=args.email)
    print(f"Wrote {args.out}")
    return 0
