"""Where do the probe kernels' times go, and which of their designs is fastest?

    python3 -m clibd_tpu_torch.tools.exp_probe_sched [--attn FILE ...] [--gemm FILE ...]
        [--copy FILE ...]

Builds scratch variants of the probe kernels `ops/attention.attention_bhnd`
(separate q, k, v), `ops/gemm.tiled_matmul` and `ops/elementwise.scale_copy`
-- each FILE, by default the committed `csrc/attention_bhnd.cu`,
`csrc/tiled_gemm.cu` and `csrc/scale_copy.cu`; a FILE may also be an earlier
version of one, which exports the same entry points and is compiled with its
own directory ahead of `csrc/` on the include path, so against the headers
of its commit unpacked beside it (`git archive <commit> clibd_tpu_torch/csrc
| tar -x -C build/prev`) -- side by side into `build/exp_probe_sched/`, and
in one process:

- attention at B=256 H=12 N=197, B=64 N=133 and B=64 N=20 (bf16): every
  variant checked against the plain version on the first 4 batch rows, then
  timed twice, interleaved (a, b, ..., b, a), beside SDPA on the same q, k, v
  (CUDA events, median of 20, `utils/profiling.cuda_ms`);
- the GEMM at 1024^3, 2048^3 and 8192^3, fp32 and bf16 out: every tile of
  every variant checked against the plain version (max |Δ| / max |plain|),
  then timed twice, interleaved, beside cuBLAS (`torch.matmul` in bf16);
- the `sections` variant of the committed GEMM launched once at 8192^3 on
  each tile: clock64 sections of thread 0 (consumer warpgroup 0), cycles a
  tile;
- with `--flash-from DIR` (a directory holding earlier versions of
  `flash_attention_qkv_phased.cu`, `flash_attention_qkv_batched.cu` and the
  `wgmma_attention.cuh` they include, which is inlined into them): the
  phased (at every head group of H=12) and batched forwards built from DIR
  and from the committed sources, on the same inputs at `FLASH_SHAPES`, and
  the count of output elements in which they differ;
- the copy y = 2 x in fp32: every variant bit-exact against x * 2 at
  `COPY_SIZES` elements (one element to one that wraps the ring with a
  ragged end), then timed twice, interleaved, beside `torch.mul(x, 2.0)`
  and `y.copy_(x)` at 64 MB (the probe's [8192, 2048]) and at each of
  `L2_MB` (copies that fit the L2), with the slope of time against bytes
  over those (the L2's copy rate).

The variants are text edits of the committed kernels' sources
(`attn_variants`, `gemm_variants`, `copy_variants`): the attention kernel
with the (batch, head) slabs a CTA walks fixed at each of `SLAB_COUNTS` (the
kernel picks them per launch, `slabs_for`); the GEMM with the tile order row
by row (`GROUP_M` = 1) and in groups of 8, and `sections`; the copy with
four vectors a thread in flight (`unroll4`), its grid capped at 8 CTAs an SM
(`capped`) and the streaming `__ldcs` / `__stcs` hints (`hints`).  The copy
it replaced (60df5e0's) gets a `no_hints` variant: plain loads
and stores in place of its hints.  Any other earlier version is built as it
is.

Needs a CUDA card and nvcc, and raises without; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops.attention import attention_bhnd_reference
from ..ops.cuda_build import CSRC
from ..ops.gemm import tiled_matmul_reference
from ..utils.profiling import card_line
from .exp_flash_sched import PROF_DECL, PROF_READ, Variant, _atomics, _edit, _interleaved, build

ATTN_SOURCE = CSRC / "attention_bhnd.cu"
GEMM_SOURCE = CSRC / "tiled_gemm.cu"
COPY_SOURCE = CSRC / "scale_copy.cu"
ATTN_SHAPES = ((256, 197), (64, 133), (64, 20))
H = 12
GEMM_SIZES = (1024, 2048, 8192)
SLAB_COUNTS = (3, 6, 12, 24)
FLASH = ("phased", "batched")
FLASH_SHAPES = ((3, 1, False), (5, 64, True), (3, 65, False), (256, 197, False), (256, 133, True),
                (3, 256, True))  # (B, N, masked) at H=12

# elements of the copy's checks: below one vector, one vector, one and a
# scalar, a ragged small one, one past a 16 KB slot, and one that wraps an
# 8-slot ring several times on every CTA with a ragged end
COPY_SIZES = (1, 3, 4, 5, 4099, 4097, 132 * 4096 * 20 + 4103)
COPY_MB = 64
L2_MB = (4, 8, 12, 16)
# the committed copy's variants (text edits): four vectors a thread in
# flight, the grid capped at 8 CTAs an SM (a grid-stride loop), and the
# streaming cache hints; the loop it replaced gets its hints taken out
COPY_UNROLL = "constexpr int UNROLL = 8;"
COPY_GRID = "  const int blocks = (int)(want < 1 ? 1 : want);\n"
COPY_LOAD = "if (i < n4) v[u] = x[i];"
COPY_STORE = ("if (i < n4) y[i] = make_float4(v[u].x * alpha, v[u].y * alpha, v[u].z * alpha, "
              "v[u].w * alpha);")
COPY_VARIANTS = {
    "unroll4": [(COPY_UNROLL, "constexpr int UNROLL = 4;")],
    "capped": [(COPY_GRID, "  int device = 0, sms = 0;\n  cudaGetDevice(&device);\n"
                "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
                "  const int blocks = (int)(want < 1 ? 1 : (want < 8L * sms ? want : 8L * sms));\n")],
    "hints": [(COPY_LOAD, "if (i < n4) v[u] = __ldcs(x + i);"),
              (COPY_STORE, "if (i < n4) __stcs(y + i, " + COPY_STORE[len("if (i < n4) y[i] = "):-1]
               + ");")]}
COPY_HINTS = [("if (i < n4) v[u] = __ldcs(x + i);", "if (i < n4) v[u] = x[i];"),
              ("__stcs(y + i, make_float4(", "(y[i] = make_float4(")]

SLABS_RETURN = "  return best;\n"  # of slabs_for
GROUP_LINE = "constexpr int GROUP_M = 16;"
TILE_LINE = re.compile(r"^CLIBD_GEMM_TILE\((\w+),", re.M)

# clock64 sections of the GEMM's thread 0, through each of its tiles
G_DECL = "    int n = 0;  // the CTA's slot sequence, as the producer's\n"
G_TILE = ("    for (int tile = first; tile < tiles; tile += step) {\n      int tm, tn;\n"
          "      tile_origin(tile, tiles_m, tiles_n, tm, tn);\n")
G_WAIT_FULL = "        mbar_wait(full + s, (n / T::STAGES) & 1);\n"
G_COMMIT = "        wgmma_commit();\n"
G_WAIT_ONE = "          wgmma_wait<1>();\n          release(n - 1);\n"
G_EPILOGUE = "      // accumulator row 16*warp + lane/4 (and + 8), columns 8j + 2(lane % 4), + 1\n"
G_END = "      }\n    }\n  }\n  // the partner arrives on this CTA's empty barriers"
GEMM_SECTIONS = ("waits for a full slot", "products issued", "waits for the group before, release",
                 "last group and release", "epilogue")


def _gemm_tick(k: int, indent: str) -> str:
    return f"{indent}c1_ = clock64();\n{indent}t{k}_ += c1_ - c0_;\n{indent}c0_ = c1_;\n"


def gemm_sections(src: str) -> str:
    """clock64 ticks of thread 0 through each tile: the waits for a full
    slot, the products' issue, the waits for the group before (and the
    release), the last group, the epilogue; the count of tiles in
    g_prof[5]"""
    src = src.replace("namespace {\n", PROF_DECL, 1)
    acc = [f"t{i}_" for i in range(len(GEMM_SECTIONS))]
    return _edit(src, [
        (G_DECL, G_DECL + "    long long " + ", ".join(f"{a} = 0" for a in acc)
         + ", c0_ = 0, c1_, tiles_ = 0;\n"),
        (G_TILE, G_TILE + "      c0_ = clock64();\n      ++tiles_;\n"),
        (G_WAIT_FULL, G_WAIT_FULL + _gemm_tick(0, " " * 8)),
        (G_COMMIT, G_COMMIT + _gemm_tick(1, " " * 8)),
        (G_WAIT_ONE, G_WAIT_ONE + _gemm_tick(2, " " * 10)),
        (G_EPILOGUE, _gemm_tick(3, " " * 6) + G_EPILOGUE),
        (G_END, "      }\n" + _gemm_tick(4, " " * 6) + "    }\n" + _atomics(acc + ["tiles_"])
         + G_END[len("      }\n    }\n"):]),
        ('extern "C" const char* clibd_cuda_error_string',
         PROF_READ + '}\n\nextern "C" const char* clibd_cuda_error_string'),
    ])


def attn_variants(src: str) -> dict:
    """{name: source}: the source as it is, and, where it picks the slabs a
    CTA walks (slabs_for), with each of SLAB_COUNTS at every shape"""
    out = {"kernel": src}
    if "int slabs_for(" in src:
        for slabs in SLAB_COUNTS:
            out[f"slabs{slabs}"] = _edit(src, [(SLABS_RETURN, f"  return {slabs};\n")])
    return out


def gemm_variants(src: str) -> dict:
    """{name: source}: the source as it is; where it has GROUP_M, the tile
    order row by row and in groups of 8, and the sections variant"""
    out = {"kernel": src}
    if GROUP_LINE in src:
        out["group1"] = src.replace(GROUP_LINE, "constexpr int GROUP_M = 1;", 1)
        out["group8"] = src.replace(GROUP_LINE, "constexpr int GROUP_M = 8;", 1)
        out["sections"] = gemm_sections(src)
    return out


def copy_variants(src: str) -> dict:
    """{name: source}: the source as it is; the committed copy with four
    vectors a thread, a capped grid and the streaming hints; the loop it
    replaced without its hints"""
    out = {"kernel": src}
    if all(old in src for edits in COPY_VARIANTS.values() for old, _ in edits):
        out.update({name: _edit(src, edits) for name, edits in COPY_VARIANTS.items()})
    elif all(old in src for old, _ in COPY_HINTS):
        out["no_hints"] = _edit(src, COPY_HINTS)
    return out


def tiles_of(src: str) -> list:
    return TILE_LINE.findall(src)


def _bind(lib, name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def _call(fn, *args) -> None:
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def _ptxas(libs: dict) -> None:
    for name, (_, log) in libs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)


def _sources(paths: list, prefix: str, variants) -> tuple:
    """({name: text} of every variant of every FILE, {name: the FILE's
    directory}, searched for its headers ahead of csrc/)"""
    texts, includes = {}, {}
    for i, path in enumerate(paths):
        for n, text in variants(path.read_text()).items():
            texts[f"{prefix}{i}_{n}"] = text
            includes[f"{prefix}{i}_{n}"] = path.parent
    return texts, includes


def run_attention(paths: list, card: str) -> None:
    libs = build(*_sources(paths, "attn", attn_variants), subdir="exp_probe_sched")
    _ptxas(libs)
    fns = {n: _bind(lib, "clibd_attention_bhnd", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p]) for n, (lib, _) in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, N in ATTN_SHAPES:
        q, k, v = (torch.randn(B, H, N, 64, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        out = torch.empty_like(q)
        want = attention_bhnd_reference(q[:4], k[:4], v[:4]).float()
        runs = {}
        for n, fn in fns.items():
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N)
            out.zero_()
            _call(fn, *args)
            torch.cuda.synchronize()
            err = float((out[:4].float() - want).abs().max())
            print(f"B={B} H={H} N={N} {n}: max|variant - plain| on 4 rows {err:.3e}", flush=True)
            runs[n] = lambda fn=fn, args=args: _call(fn, *args)
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v)
        print(f"attention B={B} H={H} N={N}, ms  [{card}]", flush=True)
        for n, ts in _interleaved(runs).items():
            print(f"  {n:28s} {', '.join(f'{t:.4f}' for t in ts)}", flush=True)
        del q, k, v, out
    torch.cuda.empty_cache()


def run_gemm(paths: list, card: str) -> None:
    texts, includes = _sources(paths, "gemm", gemm_variants)
    tiles = {n: tiles_of(text) for n, text in texts.items()}
    libs = build(texts, "exp_probe_sched", includes)
    _ptxas(libs)
    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fns = {(n, t): _bind(lib, f"clibd_tiled_gemm_{t}", argtypes)
           for n, (lib, _) in libs.items() for t in tiles[n]}
    rng = torch.Generator(device="cuda").manual_seed(1)
    for size in GEMM_SIZES:
        a, b = (torch.randn(size, size, generator=rng, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
            want = tiled_matmul_reference(a, b, dtype).float()
            top = float(want.abs().max())
            out = torch.empty(size, size, device="cuda", dtype=dtype)
            runs = {}
            for (n, t), fn in fns.items():
                if n.endswith("_sections"):
                    continue
                args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), size, size, size, code)
                out.zero_()
                _call(fn, *args)
                torch.cuda.synchronize()
                err = float((out.float() - want).abs().max()) / top
                print(f"{size}^3 {dtype} {n} {t}: max|variant - plain| / max|plain| {err:.3e}",
                      flush=True)
                runs[f"{n} {t}"] = lambda fn=fn, args=args: _call(fn, *args)
            runs["cublas"] = lambda: torch.matmul(a, b)
            flops = 2 * size ** 3
            print(f"gemm {size}^3 {dtype} out, ms (TFLOP/s of the first)  [{card}]", flush=True)
            for n, ts in _interleaved(runs).items():
                print(f"  {n:36s} {', '.join(f'{t:.4f}' for t in ts)}  "
                      f"({flops / ts[0] / 1e9:.1f})", flush=True)
            if size == GEMM_SIZES[-1] and code == 0:
                for (n, t), fn in fns.items():
                    if not n.endswith("_sections"):
                        continue
                    prof = (ctypes.c_ulonglong * 16)()
                    read = _bind(libs[n][0], "clibd_prof", [ctypes.c_void_p])
                    read(ctypes.addressof(prof))
                    _call(fn, a.data_ptr(), b.data_ptr(), out.data_ptr(), size, size, size, code)
                    torch.cuda.synchronize()
                    read(ctypes.addressof(prof))
                    count = max(prof[len(GEMM_SECTIONS)], 1)
                    print(f"  clock64 sections of {t}, thread 0, cycles a tile over {count} "
                          f"tiles: " + ", ".join(f"{s} {prof[i] / count:.0f}"
                                                 for i, s in enumerate(GEMM_SECTIONS)), flush=True)
            del want, out
        del a, b
        torch.cuda.empty_cache()


def _slope(sizes_mb, times_ms) -> float:
    """least-squares TB/s of bytes moved (read and written) against ms"""
    xs = [2 * m * 2 ** 20 for m in sizes_mb]
    mx, my = sum(xs) / len(xs), sum(times_ms) / len(times_ms)
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, times_ms))
    var = sum((x - mx) ** 2 for x in xs)
    return var / cov / 1e9 if cov > 0 else float("nan")


def run_copy(paths: list, card: str) -> None:
    libs = build(*_sources(paths, "copy", copy_variants), subdir="exp_probe_sched")
    _ptxas(libs)
    fns = {n: _bind(lib, "clibd_scale_copy", [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float,
                                                                      ctypes.c_void_p])
           for n, (lib, _) in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(3)
    for n in COPY_SIZES:
        x = torch.randn(n, generator=g, device="cuda")
        y = torch.full_like(x, float("nan"))
        for name, fn in fns.items():
            _call(fn, x.data_ptr(), y.data_ptr(), n, 2.0)
            torch.cuda.synchronize()
            if not torch.equal(y, x * 2.0):
                raise RuntimeError(f"copy variant {name} differs from x * 2 at n={n}")
    print(f"copy: every variant bit-exact against x * 2 at n = {COPY_SIZES}", flush=True)
    curves = {}
    for mb in (COPY_MB,) + L2_MB:
        x = torch.randn(mb * 2 ** 18, generator=g, device="cuda")
        y = torch.empty_like(x)
        runs = {name: (lambda fn=fn: _call(fn, x.data_ptr(), y.data_ptr(), x.numel(), 2.0))
                for name, fn in fns.items()}
        runs["torch.mul"] = lambda: torch.mul(x, 2.0)
        runs["y.copy_(x)"] = lambda: y.copy_(x)
        print(f"copy fp32 {mb} MB, ms (GB/s of the first)  [{card}]", flush=True)
        for name, ts in _interleaved(runs).items():
            print(f"  {name:28s} {', '.join(f'{t:.4f}' for t in ts)}  "
                  f"({2 * x.nbytes / ts[0] / 1e6:.1f})", flush=True)
            if mb in L2_MB:
                curves.setdefault(name, []).append(ts)
        del x, y
    for name, ts in curves.items():
        print(f"copy {name}: L2 slope over {L2_MB} MB, TB/s, each pass: " + ", ".join(
            f"{_slope(L2_MB, [t[k] for t in ts]):.2f}" for k in range(2)) + f"  [{card}]",
            flush=True)
    torch.cuda.empty_cache()


def run_flash_same(old_dir: Path) -> None:
    """the earlier and the committed phased and batched forwards on the same
    inputs: how many output elements differ"""
    core = (old_dir / "wgmma_attention.cuh").read_text().replace("#pragma once\n", "", 1)
    texts = {}
    for schedule in FLASH:
        name = f"flash_attention_qkv_{schedule}.cu"
        texts[f"{schedule}_old"] = _edit((old_dir / name).read_text(),
                                         [('#include "wgmma_attention.cuh"\n', core)])
        texts[f"{schedule}_new"] = (CSRC / name).read_text()
    libs = build(texts, "exp_probe_sched", {f"{schedule}_old": old_dir for schedule in FLASH})
    _ptxas(libs)
    variants = {n: Variant(n.split("_")[0], lib) for n, (lib, _) in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(2)
    for B, N, masked in FLASH_SHAPES:
        qkv = torch.randn(B, N, 3 * H * 64, generator=g, device="cuda").to(torch.bfloat16)
        mask = None
        if masked:
            keep = torch.rand(B, N, generator=g, device="cuda") > 0.3
            keep[:, 0] = True
            keep[0] = False  # batch row 0: every key masked
            mask = (~keep).float() * torch.finfo(torch.float32).min
        for schedule in FLASH:
            for G in ((12, 1, 2, 3, 4, 6) if schedule == "phased" else (0,)):
                outs = []
                for which in ("old", "new"):
                    out = torch.full((B, N, H * 64), float("nan"), device="cuda",
                                     dtype=torch.bfloat16)
                    variants[f"{schedule}_{which}"](qkv, mask, out, G)
                    outs.append(out)
                torch.cuda.synchronize()
                differ = int((outs[0].view(torch.int16) != outs[1].view(torch.int16)).sum())
                print(f"{schedule} G={G} B={B} N={N} mask={masked}: {differ} of "
                      f"{outs[0].numel()} elements differ between the earlier and the committed "
                      f"kernel", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--attn", type=Path, action="append", default=[])
    parser.add_argument("--gemm", type=Path, action="append", default=[])
    parser.add_argument("--copy", type=Path, action="append", default=[])
    parser.add_argument("--flash-from", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_probe_sched needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    run_attention(args.attn or [ATTN_SOURCE], card)
    run_gemm(args.gemm or [GEMM_SOURCE], card)
    run_copy(args.copy or [COPY_SOURCE], card)
    if args.flash_from:
        run_flash_same(args.flash_from)


if __name__ == "__main__":
    main()
