"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface and loaded with `ctypes`.  The library goes to
`build/kernels/` at the root of the checkout (or `$CLIBD_KERNEL_BUILD_DIR`),
named by a hash of the source, the shared headers (`csrc/*.cuh`) and the
compiler flags, so the first call after a change rebuilds and every later
call loads.  `build_libraries` starts one nvcc per source, all together;
`function` binds one C function of one library and `launch` calls an entry
point on the current stream.  Nothing here runs at import: the CPU tests import every module on a host
with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the entry points' `dtype` argument
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LOADED: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict = {}
# per kernel source: {"seconds": build wall time (0.0 when loaded from the
# cache), "log": nvcc's output (ptxas register/spill lines), "path": library}
BUILD_INFO: Dict[str, dict] = {}


def build_dir() -> Path:
    env = os.environ.get("CLIBD_KERNEL_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[2] / "build" / "kernels"


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels build only "
                       "on a machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    """`build/kernels/<name>-<hash>.so`, the hash over the source, the shared
    headers of `csrc/` and the flags."""
    blob = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        blob += header.read_bytes()
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build_libraries(names) -> None:
    """Build every `csrc/<name>.cu` whose hashed library is missing: one nvcc
    per source, all started together, then wait for all of them."""
    running = []
    for name in names:
        lib_path = _library_path(name)
        if lib_path.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "", "path": str(lib_path)})
            continue
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        # compile to a temporary name and rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
        os.close(fd)
        proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                                 str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, lib_path, time.perf_counter()))
    failed = []
    for name, proc, tmp, lib_path, t0 in running:
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log, "path": str(lib_path)}
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed to build {name}.cu:\n{log}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its hashed library is missing, then load it."""
    if name not in _LOADED:
        build_libraries([name])
        _LOADED[name] = ctypes.CDLL(str(_library_path(name)))
    return _LOADED[name]


def function(name: str, fn: str, argtypes, restype=ctypes.c_int):
    """The C function `fn` of `csrc/<name>.cu` (built and loaded on first
    use), declared with `argtypes` and `restype`; only the functions asked
    for are bound, since each library exports its own."""
    key = (name, fn)
    if key not in _FUNCTIONS:
        f = getattr(load_library(name), fn)
        f.argtypes = list(argtypes)
        f.restype = restype
        _FUNCTIONS[key] = f
    return _FUNCTIONS[key]


def launch(what: str, name: str, fn: str, pointers: list, ints: list, device,
           floats: list = ()) -> None:
    """Call the entry point `fn` of `csrc/<name>.cu` -- `pointers` (ints or
    None), `ints`, `floats`, then the current stream of `device` -- and raise
    with the CUDA error's message when it returns one (a refused launch never
    runs, and no later synchronize would report it)."""
    f = function(name, fn, [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints)
                 + [ctypes.c_float] * len(floats) + [ctypes.c_void_p])
    with torch.cuda.device(device):
        rc = f(*pointers, *ints, *floats, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        message = function(name, "clibd_cuda_error_string", [ctypes.c_int], ctypes.c_char_p)(rc)
        raise RuntimeError(f"{what} kernel launch failed: {message.decode()}")
