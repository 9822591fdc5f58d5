"""Where does the fused attention + out-projection kernel's time go?

    python3 -m clibd_tpu_torch.tools.exp_outproj [--source FILE]

Builds scratch variants of the kernel's source -- FILE, by default the
committed `csrc/flash_attention_qkv_outproj.cu` -- side by side into
`build/exp_outproj/`, and in one process, at the four shapes of
`chip_smoke.py` phase 6 (B=500, bf16):

- times every variant twice, interleaved (a, b, ..., b, a), beside the
  forward kernel alone and `torch.addmm` of the same [B*N, D] . [D, D]
  product (CUDA events, median of 20, `utils/profiling.cuda_ms`);
- launches the `sections` variant once and prints its clock64 sections,
  cycles a CTA averaged over the grid, as two of its threads saw them.

The variants are text edits of the bf16 kernel (`VARIANTS`):

- `kernel`: as it is (its output checked against the plain version, and
  `cluster`'s against its);
- `attention`: the projection cut, the context tile stored as the output;
- `projection`: the attention cut, a constant context tile projected;
- `no_products`: `projection` without its wgmma products, the W_out stream
  alone;
- `sections`: clock64 around the phases, and around the waits for W_out;
- `cluster`: CTAs in clusters of two that share W_out: each loads half of
  every slot's boxes by TMA multicast into both, a stage is refilled once
  the warpgroups of both CTAs released it, and a cluster barrier stands
  between the attention and the projection (the partner writes into this
  CTA's rings) and before the exit.  Its shapes' grids must be even, and
  it takes H = 8 and 12 only (every warpgroup projects).

FILE may also be the previous version of the file (de1d180's, an 8-warp
kernel with an mma.sync projection), compiled with its own directory ahead
of `csrc/` on the include path, so against the headers of its commit
unpacked beside it (`git archive de1d180 clibd_tpu_torch/csrc | tar -x -C
build/prev`); its variants (`PREV_VARIANTS`)
are `kernel`, `attention`, `attention_12` (12 warps, three heads at once),
`projection` and `sections`.

Needs a CUDA card and nvcc, and raises without; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
from pathlib import Path

import torch

from ..ops.attention import flash_attention_qkv_cuda, flash_attention_qkv_outproj_reference
from ..ops.cuda_build import CSRC, NVCC_FLAGS, build_dir, find_nvcc
from ..utils.profiling import card_line, cuda_ms

SOURCE = CSRC / "flash_attention_qkv_outproj.cu"
SHAPES = (("vit", 197, 12, False), ("barcode_bert", 133, 12, False), ("bert_small", 20, 8, True),
          ("barcode_bert_overlap", 657, 12, True))
B = 500

# clock64 sections: a device array, summed over CTAs, and its reader
PROF_DECL = "__device__ unsigned long long g_prof[16];\nnamespace {\n"
PROF_READ = """extern "C" {

int clibd_prof(unsigned long long* host) {
  cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""


def _atomics(pairs) -> str:
    """thread 0 and thread 128 add their sections to g_prof[0..7], [8..15]"""
    lines = "".join(f"    atomicAdd(gp + {i}, (unsigned long long)({v}));\n"
                    for i, v in enumerate(pairs))
    return ("  if (threadIdx.x == 0 || threadIdx.x == 128) {\n"
            "    unsigned long long* gp = g_prof + (threadIdx.x ? 8 : 0);\n" + lines + "  }\n")


def _edit(src: str, edits) -> str:
    """Apply (old, new) replacements, each once; raise where `old` is missing."""
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"exp_outproj: the source has no {old.strip()[:60]!r}: "
                               "update this harness")
        src = src.replace(old, new, 1)
    return src


def _between(src: str, start: str, end: str, new: str, keep_end: bool = True) -> str:
    """src with the text from `start` up to `end` (kept or not) replaced by new"""
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + new + src[j if keep_end else j + len(end):]


# ---------------------------------------------------------------------------
# the committed kernel: four warpgroups, wgmma projection
# ---------------------------------------------------------------------------
ATTENTION = "  // ---- attention:"
PROJECTION = "  // ---- projection:"
KERNEL_END = "    tma_store_commit();\n    tma_store_wait_read();\n  }\n}\n"
STORE_CONTEXT = """  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < H; ++k) tma_store_3d(&out_map, ctx + k * BOX, k * 64, q0, b);
    tma_store_commit();
    tma_store_wait_read();
  }
}
"""
CONSTANT_CONTEXT = """  const int qtiles = (N + QROWS - 1) / QROWS;
  const int b = blockIdx.x / qtiles, q0 = (blockIdx.x % qtiles) * QROWS;
  for (int i = threadIdx.x; i < L::CTX / 16; i += BF16_THREADS)
    reinterpret_cast<uint4*>(ctx)[i] = make_uint4(0x3c003c00u, 0x3c003c00u, 0x3c003c00u,
                                                  0x3c003c00u);
"""
W_WAIT = "    mbar_wait(wfull + s, (i / STAGES) & 1);\n"
W_REFILL = "    if (tw == 0 && i + STAGES < D / 16) load(i + STAGES);\n"
SYNC = "  __syncthreads();      // every head's k-slab is in the context tile\n"
SECTIONS = ("attention", "barrier", "projection", "waits for W_out", "products and refills",
            "epilogue")


def _sections(src: str) -> str:
    src = src.replace("namespace {\n", PROF_DECL, 1)
    src = _edit(src, [
        (ATTENTION,
         "  const long long p0 = clock64();\n  long long wsum = 0, msum = 0;\n" + ATTENTION),
        (PROJECTION, "  const long long p1 = clock64();\n" + PROJECTION),
        (SYNC, SYNC + "  const long long p2 = clock64();\n"),
        (W_WAIT, "    const long long w0 = clock64();\n" + W_WAIT
         + "    const long long w1 = clock64();\n    wsum += w1 - w0;\n"),
        (W_REFILL, W_REFILL + "    msum += clock64() - w1;\n"),
        ("  // ---- epilogue:", "  const long long p3 = clock64();\n  // ---- epilogue:"),
        (KERNEL_END, KERNEL_END[:-2] + _atomics(["p1 - p0", "p2 - p1", "p3 - p2", "wsum", "msum",
                                                  "clock64() - p3"]) + "}\n"),
        ('extern "C" {\n', PROF_READ),
    ])
    return src


def _cluster(src: str) -> str:
    return _edit(src, [
        ("__global__ void __launch_bounds__(BF16_THREADS, 1)\n",
         "__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(BF16_THREADS, 1)\n"),
        ("  static constexpr int BARRIERS = 8 * 4 * (2 + W_STAGES);",
         "  static constexpr int BARRIERS = 8 * 4 * (2 + 2 * W_STAGES);"),
        ("+ wg * (2 + STAGES);\n  uint64_t* wfull = afull + 2;\n",
         "+ wg * (2 + 2 * STAGES);\n  uint64_t* wfull = afull + 2;\n"
         "  uint64_t* wempty = wfull + STAGES;\n  const uint32_t rank = cluster_ctarank();\n"),
        ("    for (int s = 0; s < 2 + STAGES; ++s) mbar_init(afull + s, 1);\n",
         "    for (int s = 0; s < 2 + STAGES; ++s) mbar_init(afull + s, 1);\n"
         "    for (int s = 0; s < STAGES; ++s) mbar_init(wempty + s, 2);\n"),
        ("    for (int j = 0; j < NW / 64; ++j)  // [16, 64] boxes of 128-byte rows, 2 KB apart\n"
         "      tma_load_2d(ring + (m % STAGES) * L::W_SLOT + j * 2048, &w_map, wfull + m % STAGES,\n"
         "                  wg * NW + j * 64, m * 16);\n",
         "    for (int j = rank; j < NW / 64; j += 2)\n"
         "      tma_load_2d_multicast(ring + (m % STAGES) * L::W_SLOT + j * 2048, &w_map,\n"
         "                            wfull + m % STAGES, wg * NW + j * 64, m * 16, 3);\n"),
        ("  if (tw == 0 && wg < PW)\n    for (int m = 0; m < STAGES; ++m) load(m);\n"
         "  fence_proxy_async();  // the context stores, visible to wgmma\n"
         "  __syncthreads();      // every head's k-slab is in the context tile\n",
         "  fence_proxy_async();\n  cluster_sync();\n"
         "  if (tw == 0 && wg < PW)\n    for (int m = 0; m < STAGES; ++m) load(m);\n"),
        ("    if (tw == 0 && i + STAGES < D / 16) load(i + STAGES);\n",
         "    if (tw == 0) {\n      mbar_arrive(wempty + s);\n"
         "      mbar_arrive_cluster(wempty + s, rank ^ 1);\n"
         "      if (i + STAGES < D / 16) {\n        mbar_wait(wempty + s, (i / STAGES) & 1);\n"
         "        load(i + STAGES);\n      }\n    }\n"),
        (KERNEL_END, KERNEL_END[:-2] + "  cluster_sync();\n}\n"),
    ])


VARIANTS = {
    "kernel": lambda src: src,
    "attention": lambda src: _between(src, PROJECTION, KERNEL_END, STORE_CONTEXT,
                                      keep_end=False),
    "projection": lambda src: _between(src, ATTENTION, PROJECTION, CONSTANT_CONTEXT),
    "no_products": lambda src: re.sub(r"    Wgmma<NW, 1>::mma\(.*?\);\n", "",
                                      VARIANTS["projection"](src), count=1, flags=re.S),
    "sections": _sections,
    "cluster": _cluster,
}

# ---------------------------------------------------------------------------
# the previous kernel: 8 warps, two heads at a time, mma.sync projection
# ---------------------------------------------------------------------------
PREV_MARK = "attend_head_group<WARPS / 4>"
PREV_PROJECT = ("  project(ctx, reinterpret_cast<__nv_bfloat16*>(region), w, bias, out, "
               "(long)c.b * N + c.q0,\n          c.rows, D);\n")
PREV_COPY_OUT = """  for (int idx = threadIdx.x; idx < c.rows * (D / 8); idx += THREADS) {
    const int r = idx / (D / 8), col = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(out + ((long)c.b * N + c.q0 + r) * D + col) =
        *reinterpret_cast<const uint4*>(ctx + r * CS + col);
  }
"""
PREV_ATTENTION = "  for (int h0 = 0; h0 < H; h0 += WARPS / 4) {\n"
PREV_DONE = "  __syncthreads();  // the context tile is complete\n"
PREV_CONSTANT = """  for (int idx = threadIdx.x; idx < QROWS * (D / 8); idx += THREADS)
    *reinterpret_cast<uint4*>(ctx + (idx / (D / 8)) * CS + (idx % (D / 8)) * 8) =
        make_uint4(0x3c003c00u, 0x3c003c00u, 0x3c003c00u, 0x3c003c00u);
"""
PREV_SECTIONS = ("attention", "barrier", "projection", "waits for W_out chunks",
                "issuing the next chunk's cp.async copies", "mma.sync products", "epilogue")


def _prev_sections(src: str) -> str:
    src = src.replace("namespace {\n", PROF_DECL, 1)
    i = src.index("outproj_bf16_kernel(")
    head, body = src[:i], src[i:]
    head = _edit(head, [
        ("  float acc[8][4];\n",
         "  float acc[8][4];\n  long long tw = 0, ti = 0, tp = 0, te = 0, s0;\n"),
        ("    cp_async_wait_all();\n    __syncthreads();  // chunk i landed for all; chunk i-1's "
         "buffer is free\n",
         "    s0 = clock64();\n    cp_async_wait_all();\n    __syncthreads();  // chunk i landed\n"
         "    tw += clock64() - s0;\n    s0 = clock64();\n"),
        ("    const __nv_bfloat16* wb = wbuf + (i & 1) * KC * WS;\n",
         "    ti += clock64() - s0;\n    const __nv_bfloat16* wb = wbuf + (i & 1) * KC * WS;\n"
         "    s0 = clock64();\n"),
        ("    if (kc == kchunks - 1) {\n      const int r0",
         "    { const long long s1 = clock64(); tp += s1 - s0; s0 = s1; }\n"
         "    if (kc == kchunks - 1) {\n      const int r0"),
        ("acc[j][3] + b1);\n      }\n    }\n  }\n}",
         "acc[j][3] + b1);\n      }\n      te += clock64() - s0;\n    }\n  }\n"
         "  if (threadIdx.x == 0) {\n    atomicAdd(&g_prof[3], (unsigned long long)tw);\n"
         "    atomicAdd(&g_prof[4], (unsigned long long)ti);\n"
         "    atomicAdd(&g_prof[5], (unsigned long long)tp);\n"
         "    atomicAdd(&g_prof[6], (unsigned long long)te);\n  }\n}"),
    ])
    body = _edit(body, [
        (PREV_ATTENTION, "  const long long p0 = clock64();\n" + PREV_ATTENTION),
        (PREV_DONE, "  const long long p1 = clock64();\n" + PREV_DONE
         + "  const long long p2 = clock64();\n"),
        (PREV_PROJECT, PREV_PROJECT + "  if (threadIdx.x == 0) {\n"
         "    atomicAdd(&g_prof[0], (unsigned long long)(p1 - p0));\n"
         "    atomicAdd(&g_prof[1], (unsigned long long)(p2 - p1));\n"
         "    atomicAdd(&g_prof[2], (unsigned long long)(clock64() - p2));\n  }\n"),
        ('extern "C" {\n', PROF_READ),
    ])
    return head + body


PREV_VARIANTS = {
    "kernel": lambda src: src,
    "attention": lambda src: _edit(src, [(PREV_PROJECT, PREV_COPY_OUT)]),
    "attention_12": lambda src: _edit(src, [
        (PREV_PROJECT, PREV_COPY_OUT), ("constexpr int WARPS = 8;", "constexpr int WARPS = 12;")]),
    "projection": lambda src: _between(src, PREV_ATTENTION, PREV_DONE, PREV_CONSTANT),
    "sections": _prev_sections,
}


def variants_of(src: str) -> tuple:
    """({name: edited source}, section names) for a source of either kind"""
    prev = PREV_MARK in src
    table = PREV_VARIANTS if prev else VARIANTS
    return {name: edit(src) for name, edit in table.items()}, PREV_SECTIONS if prev else SECTIONS


def build(sources: dict, include: Path = CSRC) -> dict:
    """One nvcc per variant, all together → {name: its CDLL}; `include` is
    searched for the headers ahead of `csrc/`."""
    out = build_dir() / "exp_outproj"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-I", str(include), "-I", str(CSRC), "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
        libs[name].clibd_flash_attention_qkv_outproj.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return libs


def launch(lib, qkv, mask, w, bias, out, H) -> None:
    rc = lib.clibd_flash_attention_qkv_outproj(
        qkv.data_ptr(), None if mask is None else mask.data_ptr(), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), qkv.shape[0], qkv.shape[1], H, 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path, default=SOURCE)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("exp_outproj needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    sources, sections = variants_of(args.source.read_text())
    libs = build(sources, args.source.parent)
    names = [n for n in libs if n != "sections"]
    runs_on = {"cluster": lambda N, H: H in (8, 12) and B * -(-N // 64) % 2 == 0}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for shape, N, H, masked in SHAPES:
        D = H * 64
        qkv = torch.randn(B, N, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        mask = None
        if masked:
            keep = torch.rand(B, N, generator=g, device=dev) > 0.3
            keep[:, 0] = True
            mask = (~keep).float() * torch.finfo(torch.float32).min
        w = (torch.randn(D, D, generator=g, device=dev) / math.sqrt(D)).to(torch.bfloat16)
        bias = 0.1 * torch.randn(D, generator=g, device=dev)
        ctx = torch.randn(B * N, D, generator=g, device=dev).to(torch.bfloat16)
        out = torch.empty(B, N, D, device=dev, dtype=torch.bfloat16)
        launch(libs["kernel"], qkv, mask, w, bias, out, H)
        want = flash_attention_qkv_outproj_reference(qkv[:8], w, bias, H,
                                                     None if mask is None else mask[:8]).float()
        rel = float((out[:8].float() - want).abs().max() / want.abs().max())
        same = {}  # a variant that computes the same function, against the kernel's bits
        if "cluster" in libs and runs_on["cluster"](N, H):
            other = torch.empty_like(out)
            launch(libs["cluster"], qkv, mask, w, bias, other, H)
            same["cluster"] = torch.equal(other, out)
        runs = {
            **{n: (lambda n=n: launch(libs[n], qkv, mask, w, bias, out, H)) for n in names
               if runs_on.get(n, lambda N, H: True)(N, H)},
            "forward kernel": lambda: flash_attention_qkv_cuda(qkv, H, mask),
            "addmm": lambda: torch.addmm(bias.to(torch.bfloat16), ctx, w),
        }
        times = {n: [] for n in runs}
        for n in list(runs) + list(runs)[::-1]:
            times[n].append(cuda_ms(runs[n]))
        print(f"{shape} B={B} N={N} H={H} mask={masked}: kernel vs plain (8 rows) "
              f"max|diff|/max|plain| {rel:.3e}"
              + "".join(f"; {n} bit-identical to it: {v}" for n, v in same.items())
              + f"  [{card}]", flush=True)
        for n, ts in times.items():
            print(f"  {n:16s} ms {', '.join(f'{t:.4f}' for t in ts)}", flush=True)
        prof = (ctypes.c_ulonglong * 16)()
        reader = libs["sections"].clibd_prof
        reader.argtypes = [ctypes.c_void_p]
        reader(ctypes.addressof(prof))
        launch(libs["sections"], qkv, mask, w, bias, out, H)
        torch.cuda.synchronize()
        reader(ctypes.addressof(prof))
        ctas = B * -(-N // 64)
        for who, base in (("thread 0", 0), ("thread 128", 8)):
            if any(prof[base:base + 8]):
                print(f"  clock64 sections, {who}, cycles a CTA: " + ", ".join(
                    f"{s} {prof[base + i] / ctas:.0f}" for i, s in enumerate(sections)), flush=True)
        del qkv, mask, ctx, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
