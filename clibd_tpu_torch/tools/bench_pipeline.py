"""Input-pipeline throughput on the host: the port of the repository's
`tools/bench_pipeline.py` (the reference's
epoch/special_epoch_for_loading_speed_test.py, its manual loader probe).

    python3 -m clibd_tpu_torch.tools.bench_pipeline [hdf5_path] [batch_size]

Decoded training batches a second through `data/pipeline.BioscanLoader`,
with the Python/PIL decode at 0 and 4 workers and with the native C++ pool
at 0 and 4 workers (where `native/` builds), over the given file's
no_split_and_seen_train split or a synthetic one of 256 records
(`tools/fixtures.make_tiny_bioscan_hdf5`); batch 64 unless given.  No
device takes part.  Needs h5py.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time


def run(path: str = None, batch: int = 64) -> list:
    """→ one {name, images_per_s, images, seconds} a loader setting."""
    from ..data.native import load_native_decoder
    from ..data.pipeline import BatchSpec, BioscanLoader

    tmpdir = None
    if path is None:
        from .fixtures import make_tiny_bioscan_hdf5

        tmpdir = tempfile.mkdtemp(prefix="bench_pipeline_")
        path = os.path.join(tmpdir, "fixture.hdf5")
        make_tiny_bioscan_hdf5(path, n_per_split=256, splits=("no_split_and_seen_train",))
        print(f"synthetic fixture: {path}")
    rows = []
    try:
        for name, native, workers in (("python+PIL, 0 workers", False, 0),
                                      ("python+PIL, 4 workers", False, 4),
                                      ("native C++ pool", True, 0),
                                      ("native C++ pool, 4 workers", True, 4)):
            decoder = load_native_decoder() if native else None
            if native and decoder is None:
                print("native decoder unavailable")
                continue
            loader = BioscanLoader(path, "no_split_and_seen_train",
                                   BatchSpec(batch_size=batch, train=True), num_workers=workers,
                                   decoder=decoder)
            t0 = time.perf_counter()
            n = sum(b["image"].shape[0] for b in loader.batches(epoch=0))
            dt = time.perf_counter() - t0
            loader.close()
            rows.append({"name": name, "images_per_s": n / dt, "images": n, "seconds": dt})
            print(f"{name}: {n / dt:.1f} images/s ({n} images in {dt:.2f}s)", flush=True)
    finally:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("hdf5_path", nargs="?", default=None)
    ap.add_argument("batch_size", nargs="?", type=int, default=64)
    args = ap.parse_args(argv)
    return run(args.hdf5_path, args.batch_size)


if __name__ == "__main__":
    main()
