"""End-to-end extraction benchmark: HDF5 -> decode and transform -> encode on
the card -> embedding HDF5: the port of the repository's
`tools/bench_extract.py`.

    python3 -m clibd_tpu_torch.tools.bench_extract [n_records] [batch] [num_workers] [--device cpu]

(defaults: 4096 records, batch 256, 4 workers)

Writes a synthetic test_seen split of unique 256 x 256 JPEGs (about the
BIOSCAN cropped_256 payload; `tools/fixtures.make_tiny_bioscan_hdf5`) and
reports three rates, so that the host-bound and device-bound shares are
apart:

- host_only: the loader's samples/s with the model removed (a first pass
  warms the page cache);
- device_only: `tools/bench.run_bench` on inputs already on the card (the
  body of `cli bench`);
- end_to_end: `engine/extract.extract_split` with the output write, after
  a warm pass.

The model is `tools/bench.py`'s (the flagship's ViT-B/16 and BarcodeBERT,
no text, no LoRA, a seeded fresh init, bf16).  Prints one JSON line, with
the card's name and power limit on the card.  Needs h5py.  `--device cpu`
runs it on the CPU, only when asked.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch

from .bench import flagship_config


def run(n_records: int = 4096, batch: int = 256, workers: int = 4,
        device: torch.device | str = "cuda", card=None) -> dict:
    from ..data.native import load_native_decoder
    from ..data.pipeline import BatchSpec, BioscanLoader
    from ..engine.extract import extract_split, save_extracted_features
    from ..models.clibd import init_clibd_model
    from .bench import run_bench
    from .fixtures import make_tiny_bioscan_hdf5

    device = torch.device(device)
    tmpdir = tempfile.mkdtemp(prefix="bench_extract_")
    try:
        path = os.path.join(tmpdir, "fixture.hdf5")
        t0 = time.perf_counter()
        make_tiny_bioscan_hdf5(path, n_per_split=n_records, splits=("test_seen",),
                               image_hw=(256, 256))
        print(f"fixture: {n_records} records, {os.path.getsize(path) / 1e6:.0f} MB, built in "
              f"{time.perf_counter() - t0:.0f}s", flush=True)
        cfg = flagship_config()
        model = init_clibd_model(cfg, torch.Generator().manual_seed(0), device)
        decoder = load_native_decoder()
        spec = BatchSpec(batch_size=batch, train=False, with_language=False,
                         transport_uint8=True, image_size=cfg.image.vit.image_size)

        def new_loader():
            return BioscanLoader(path, "test_seen", spec, num_workers=workers, prefetch=3,
                                 decoder=decoder)

        # host only: drain the pipeline, no model
        loader = new_loader()
        for _ in loader.batches():  # warm the page cache
            pass
        t0 = time.perf_counter()
        n = sum(b["image"].shape[0] for b in loader.batches())
        host_dt = time.perf_counter() - t0
        loader.close()

        # end to end: extract_split and the write, after a warm pass
        for timed in (False, True):
            loader = new_loader()
            t0 = time.perf_counter()
            out = extract_split(model, cfg, loader, for_key_set=False)
            if timed:
                save_extracted_features(os.path.join(tmpdir, "out.hdf5"), out, out, out)
            e2e_dt = time.perf_counter() - t0
            loader.close()
        if out["encoded_image_feature"].shape[0] != n_records:
            raise RuntimeError(f"bench_extract: {out['encoded_image_feature'].shape[0]} rows "
                               f"extracted of {n_records}")

        # device only: the encode on inputs already on the device
        dev = run_bench(cfg, batch=batch, device=device, model=model)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result = {"host_only_samples_per_s": round(n / host_dt, 1),
              "device_only_samples_per_s": dev["value"],
              "end_to_end_samples_per_s": round(n_records / e2e_dt, 1),
              "records": n_records, "batch": batch, "num_workers": workers,
              "native_decoder": decoder is not None, "host_cpus": os.cpu_count(),
              "device": device.type, "card": card}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_records", nargs="?", type=int, default=4096)
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("num_workers", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.profiling import require_card

    card = require_card("bench_extract", args.device)
    return run(args.n_records, args.batch, args.num_workers, args.device, card)


if __name__ == "__main__":
    main()
