# A copy of clibd_tpu/data/native.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""ctypes bindings for the native C++ decode/transform pool
(native/decoder.cpp).  Falls back gracefully when the shared library is not
built — `load_native_decoder()` returns None and the pipeline uses the
PIL/numpy path."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_LIB_NAME = "libclibd_native.so"


def native_lib_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native", _LIB_NAME)


def _native_is_fresh(path: str, native_dir: str) -> bool:
    """True when the built .so is newer than every source/Makefile — the
    common case, decided WITHOUT a subprocess."""
    if not os.path.exists(path):
        return False
    so_mtime = os.path.getmtime(path)
    for name in os.listdir(native_dir):
        if name.endswith((".cpp", ".cc", ".c", ".h", ".hpp")) or name == "Makefile":
            if os.path.getmtime(os.path.join(native_dir, name)) > so_mtime:
                return False
    return True


def build_native(verbose: bool = False) -> Optional[str]:
    """Build the shared library with make; returns its path or None.

    Freshness is checked in-process first, so the steady state costs no
    subprocess.  An actual rebuild takes an exclusive flock: on a multi-host
    pod with the repo on a shared filesystem, every process builds loaders
    at startup, and an unserialized `make` could relink the .so while a
    sibling process is mid-dlopen (code-review finding)."""
    path = native_lib_path()
    native_dir = os.path.dirname(path)
    if _native_is_fresh(path, native_dir):
        return path
    try:
        import fcntl

        with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _native_is_fresh(path, native_dir):  # a sibling built it
                return path
            subprocess.run(
                ["make", "-C", native_dir],
                check=True,
                capture_output=not verbose,
            )
    except Exception:
        return None
    return path if os.path.exists(path) else None


class NativeDecoder:
    """Batch decode+transform via the C++ pool (thread count configurable)."""

    def __init__(self, lib_path: Optional[str] = None, num_threads: int = 0):
        path = lib_path or native_lib_path()
        self.lib = ctypes.CDLL(path)
        self.lib.clibd_decode_transform_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # jpegs
            ctypes.POINTER(ctypes.c_int64),  # offsets
            ctypes.c_int,                    # n
            ctypes.POINTER(ctypes.c_float),  # out
            ctypes.c_int,                    # out_size
            ctypes.c_int,                    # resize_to
            ctypes.c_int,                    # mode
            ctypes.c_int,                    # dct_scale
            ctypes.POINTER(ctypes.c_uint64), # seeds
            ctypes.POINTER(ctypes.c_int32),  # ok
            ctypes.c_int,                    # num_threads
        ]
        self.lib.clibd_decode_transform_batch_two_view.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # jpegs
            ctypes.POINTER(ctypes.c_int64),  # offsets
            ctypes.c_int,                    # n
            ctypes.POINTER(ctypes.c_float),  # out1
            ctypes.POINTER(ctypes.c_float),  # out2
            ctypes.c_int,                    # out_size
            ctypes.c_int,                    # resize_to
            ctypes.c_int,                    # dct_scale
            ctypes.POINTER(ctypes.c_uint64), # seeds1
            ctypes.POINTER(ctypes.c_uint64), # seeds2
            ctypes.POINTER(ctypes.c_int32),  # ok
            ctypes.c_int,                    # num_threads
        ]
        self.lib.clibd_version.restype = ctypes.c_int
        assert self.lib.clibd_version() == 3
        self.num_threads = num_threads if num_threads > 0 else (os.cpu_count() or 1)

    def decode_transform_batch(
        self,
        jpegs: List[bytes],
        rng: Optional[np.random.Generator] = None,
        train: bool = False,
        size: int = 224,
        resize_to: int = 256,
        long_edge: bool = False,
        dct_scale: Optional[bool] = None,
    ) -> np.ndarray:
        """dct_scale: decode oversized sources at m/8 scale inside the IDCT
        (~(m/8)^2 of the decode cost; the antialiased resize finishes from
        the scaled image).  Default: ON for train (the filter difference is
        far below augmentation noise — tests/test_native.py tolerance test),
        OFF for eval so extraction stays bit-identical for checkpoint
        parity.  Production 256px-crop sources at resize_to=256 are
        unaffected either way (no reduction applies); eval on those takes
        the bit-exact crop-window decode fast path instead."""
        if long_edge:
            # the rare transform_with_resize eval variant stays on the numpy path
            from .transforms import eval_transform

            return np.stack([eval_transform(j, size, resize_to, long_edge=True) for j in jpegs])

        n = len(jpegs)
        blob = b"".join(jpegs)
        buf = np.frombuffer(blob, dtype=np.uint8)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(j) for j in jpegs], out=offsets[1:])
        out = np.empty((n, size, size, 3), dtype=np.float32)
        ok = np.zeros(n, dtype=np.int32)
        if train:
            seed_rng = rng if rng is not None else np.random.default_rng()
            seeds = seed_rng.integers(1, 2**63, size=n, dtype=np.uint64)
        else:
            seeds = np.zeros(n, dtype=np.uint64)
        self.lib.clibd_decode_transform_batch(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            size,
            resize_to,
            1 if train else 0,
            1 if (train if dct_scale is None else dct_scale) else 0,
            seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.num_threads,
        )
        if not ok.all():
            bad = np.where(ok == 0)[0]
            raise ValueError(f"native decode failed for batch items {bad.tolist()}")
        return out

    def decode_transform_two_view(
        self,
        jpegs: List[bytes],
        rng1: np.random.Generator,
        rng2: np.random.Generator,
        size: int = 224,
        resize_to: int = 256,
        dct_scale: bool = True,
    ):
        """SimCLR two-view: decode+resize each JPEG once in C++, return two
        independently-cropped views ([n,size,size,3] f32 each)."""
        n = len(jpegs)
        blob = b"".join(jpegs)
        buf = np.frombuffer(blob, dtype=np.uint8)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(j) for j in jpegs], out=offsets[1:])
        out1 = np.empty((n, size, size, 3), dtype=np.float32)
        out2 = np.empty((n, size, size, 3), dtype=np.float32)
        ok = np.zeros(n, dtype=np.int32)
        seeds1 = rng1.integers(1, 2**63, size=n, dtype=np.uint64)
        seeds2 = rng2.integers(1, 2**63, size=n, dtype=np.uint64)
        self.lib.clibd_decode_transform_batch_two_view(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            out1.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            size,
            resize_to,
            1 if dct_scale else 0,
            seeds1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            seeds2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.num_threads,
        )
        if not ok.all():
            bad = np.where(ok == 0)[0]
            raise ValueError(f"native two-view decode failed for batch items {bad.tolist()}")
        return out1, out2


_build_attempted = False


def load_native_decoder(num_threads: int = 0, build_if_missing: bool = True) -> Optional[NativeDecoder]:
    global _build_attempted
    path = native_lib_path()
    if build_if_missing and not _build_attempted:
        # run make BEFORE the first dlopen (once per process): it is a no-op
        # when the .so is fresh, and relinks a stale one from an older source
        # version.  A rebuild-after-failed-load cannot work in-process
        # (dlopen caches by path, so a retry returns the already-mapped stale
        # library — and relinking a mapped .so risks corrupting it mid-run).
        _build_attempted = True
        build_native()
    if not os.path.exists(path):
        return None
    try:
        return NativeDecoder(path, num_threads=num_threads)
    except Exception:
        return None
