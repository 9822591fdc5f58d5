"""Native JPEG decode and transform throughput per core: the port of the
repository's `tools/bench_decode.py`.

    python3 -m clibd_tpu_torch.tools.bench_decode [--lib PATH] [--n N]

Images a second on one thread of the native decoder (`native/`,
`data/native.NativeDecoder`) at the production geometry (256 px crops ->
eval CenterCrop(224) / train RandomResizedCrop(224)) and on 600 x 800
sources with DCT-scaled decode off and on; JPEGs made with PIL from a
seeded generator.  --lib times another build of the library (an A/B);
otherwise the repository's library, built with make where it is missing
or stale.  It names the library it timed.  Host only: no device takes
part, and it raises where the library cannot be loaded.
"""

from __future__ import annotations

import argparse
import io
import time

import numpy as np


def make_jpegs(n: int, h: int, w: int, smooth: bool = True) -> list:
    from PIL import Image

    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        if smooth:
            y, x = np.mgrid[0:h, 0:w].astype(np.float32)
            r = 127 + 100 * np.sin(x / (31.0 + i % 7)) * np.cos(y / 23.0)
            g = 127 + 100 * np.cos(x / 29.0 + i)
            b = 127 + 100 * np.sin((x + y) / 51.0)
            arr = np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
        else:
            arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=85)
        out.append(buf.getvalue())
    return out


def rate(dec, jpegs: list, repeats: int = 3, **kw) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        dec.decode_transform_batch(jpegs, rng=np.random.default_rng(1), **kw)
        best = min(best, time.perf_counter() - t0)
    return len(jpegs) / best


def decoder(lib: str = None):
    """(one-thread decoder, the library's path): `lib`, or the repository's
    library built where needed."""
    from ..data.native import NativeDecoder, build_native, native_lib_path

    path = lib or build_native() or native_lib_path()
    return NativeDecoder(path, num_threads=1), path


def run(n: int = 256, lib: str = None) -> list:
    dec, path = decoder(lib)
    print(f"library: {path}", flush=True)
    j256 = make_jpegs(n, 256, 256)
    big = make_jpegs(max(n // 4, 1), 600, 800)
    rows = [("eval 256->224 (production)", rate(dec, j256, train=False)),
            ("train 256->224 (production)", rate(dec, j256, train=True)),
            ("eval 600x800->224, dct off", rate(dec, big, train=False, dct_scale=False)),
            ("eval 600x800->224, dct on", rate(dec, big, train=False, dct_scale=True)),
            ("train 600x800->224, dct off", rate(dec, big, train=True, dct_scale=False)),
            ("train 600x800->224, dct on", rate(dec, big, train=True, dct_scale=True))]
    for name, r in rows:
        print(f"{name:32s} {r:8.1f} img/s/core", flush=True)
    return [{"name": name, "images_per_s": r, "library": path} for name, r in rows]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", default=None)
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args(argv)
    return run(args.n, args.lib)


if __name__ == "__main__":
    main()
