"""Where do the phased forward and backward kernels' times go, and rows 1 and 2's?

    python3 -m clibd_tpu_torch.tools.exp_flash_sched [--phased FILE] [--batched FILE]
        [--bwd FILE ...]
    python3 -m clibd_tpu_torch.tools.exp_flash_sched --row1 [FILE ...]
    python3 -m clibd_tpu_torch.tools.exp_flash_sched --row2 [FILE ...]

`--row1` times the main path's forward alone (`csrc/flash_attention_qkv.cu`)
at the main path's four shapes, B=500 (ViT N=197, BarcodeBERT N=133,
BERT-small N=20 H=8 masked, the overlap tower's N=657 masked): the
committed kernel with 1, 2 and 4 warpgroups a CTA (through
`clibd_flash_attention_qkv_fwd_w`), its `l2_only` and `no_softmax`
variants at the number it picks, each FILE as it is (an earlier version of
the file, say 4605cf6's key-tiled mma.sync kernel, unpacked with its headers
as below), v0 (the wrapper) and SDPA, each checked on 8
rows and timed twice, interleaved; then the `sections` variant's clock64
cycles of thread 0 an item (the wait for q, per key block the wait for K,
S, the softmax, the wait for V, P.V, the slot's release, the context's
store).

`--row2` times the main path's backward alone (`csrc/flash_attention_qkv_bwd.cu`)
at the same four shapes, B=500: the committed kernel with each route forced
through its entry point's `route` argument (`row`, the whole row on chip,
where N <= 208; `tiled`, key-tiled with a second sweep for dQ), each FILE as
it is (an earlier version of the file, say the mma.sync row and column
kernels of 1b418aa, or a design to compare), v0 (the wrapper) and SDPA's
backward, each checked on 8 rows and timed twice, interleaved; then each
route's clock64 sections of thread 0: the whole-row route's through the
core (`--bwd`'s BWD_SECTIONS), the key-tiled route's from the source's
BWD_TICK hooks (the row kernel's eight sections a CTA, the column kernel's
six an item).

Every FILE of every mode is compiled with its own directory ahead of
`csrc/` on the include path, so an earlier version builds against the
headers of its own commit, unpacked beside it:

    mkdir -p build/prev && git archive 1b418aa clibd_tpu_torch/csrc | tar -x -C build/prev
    python3 -m clibd_tpu_torch.tools.exp_flash_sched \
        --row2 build/prev/clibd_tpu_torch/csrc/flash_attention_qkv_bwd.cu

Builds scratch variants of the two forward schedules of `tools/exp_flash.py`
-- FILE, by default the committed `csrc/flash_attention_qkv_phased.cu` and
`csrc/flash_attention_qkv_batched.cu` -- and of its phased backward (each
`--bwd` FILE, by default the committed
`csrc/flash_attention_qkv_bwd_phased.cu`) side by side into
`build/exp_flash_sched/`, and in one process, at the harness's shapes (B=256,
H=12, bf16; N=197 unmasked and N=133 with a random key mask):

- checks every variant that computes the same function against the plain
  version on the first 8 batch rows;
- times every variant twice, interleaved (a, b, ..., b, a), beside the
  forward kernel (`v0`) and SDPA on the same inputs (CUDA events, median of
  20, `utils/profiling.cuda_ms`);
- launches each `sections` variant once and prints its clock64 sections of
  thread 0, cycles a CTA (or an item of warpgroup 0) averaged over the grid.

The variants are text edits of a source (`KINDS`, told apart by a marker in
the text).  The committed kernels' (`NEW_VARIANTS`, each of which inlines
the shared core `csrc/wgmma_attention.cuh` to edit it): `kernel`, as it is,
the phased one also at every head group of `PHASED_GROUPS`; `sections`
(`SECTIONS`, through each item of warpgroup 0); `early_issue` (each product
issued as soon as its own box has landed); and, computing another function,
`l2_only` (every load from batch element 0, so from L2), `no_softmax` (P =
S rounded) and `kv_once` (K and V loaded only by the first query tile's
CTAs).  A source may also be the previous version of a file (from
8075b1f, with its headers): an mma.sync kernel fed by cp.async.
Its phased variants are `kernel` and `sections` (the K copy, phase 1 (S),
the barrier after it, phase 2 (the softmaxes, V's copies issued), the wait
for V with its barrier, phase 3 (P.V and the store)); its batched ones
`kernel`, `sections` (issuing copies, the copy waits with their barrier,
`attend_rows_bf16`, the context into the tile, the barrier after a head,
the context store), `no_tile` (each head's context stored straight from
registers, no context tile: still one CTA of 4 warps a SM, two stages of
K and V) and `no_tile_1stage` (the same with one stage: three CTAs, 12
warps a SM).

The backward's variants (`bwd_variants`) are `kernel` and `sections`: the
clock64 cycles of thread 0 a CTA, for the committed kernel (its core,
`csrc/wgmma_attention_bwd.cuh`, inlined; `BWD_SECTIONS`:
the loads issued and K/V waited for, the row phase, the barrier after it,
the wait for Q and dO, the column phase; and through each query block of
warpgroup 0: the wait for q and dO, S, the softmax, dP, rowsum(P * dP)
with dS and Pb, the warpgroup's barrier, the Pb/dS stores, dQ) and for the
previous one
(`PREV_BWD_SECTIONS`, 60df5e0's: an mma.sync kernel fed by
cp.async; K/V staged, the row phase, the barrier, the Q/dO copy with its
wait, the column phase).  Each is checked against the plain version on the
first 8 batch rows and timed twice, interleaved, beside the backward kernel
(`v0`) and SDPA's backward.  A source of neither kind is built as it is.

Needs a CUDA card and nvcc, and raises without; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from ..ops.attention import (
    flash_attention_qkv_bwd_cuda,
    flash_attention_qkv_bwd_reference,
    flash_attention_qkv_cuda,
    flash_attention_qkv_reference,
)
from ..ops.cuda_build import CSRC, NVCC_FLAGS, build_dir, find_nvcc
from ..utils.profiling import card_line, cuda_ms
from .exp_flash import sdpa

SOURCES = {"phased": CSRC / "flash_attention_qkv_phased.cu",
           "batched": CSRC / "flash_attention_qkv_batched.cu"}
SHAPES = ((197, False), (133, True))
B, H = 256, 12
PHASED_GROUPS = (1, 2, 3, 4, 6)  # and 12, the largest, as `phased_kernel`

# clock64 sections: a device array, summed over CTAs, and its reader
PROF_DECL = "__device__ unsigned long long g_prof[16];\nnamespace {\n"
PROF_READ = """extern "C" {

int clibd_prof(unsigned long long* host) {
  cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""


def _atomics(values, first: int = 0, who: str = "threadIdx.x == 0") -> str:
    """thread 0 adds its sections to g_prof[first ..]"""
    lines = "".join(f"    atomicAdd(g_prof + {first + i}, (unsigned long long)({v}));\n"
                    for i, v in enumerate(values))
    return f"  if ({who}) {{\n" + lines + "  }\n"


def _edit(src: str, edits) -> str:
    """Apply (old, new) replacements, each once; raise where `old` is missing."""
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"exp_flash_sched: the source has no {old.strip()[:60]!r}: "
                               "update this harness")
        src = src.replace(old, new, 1)
    return src


def _profiled(src: str, edits) -> str:
    return _edit(src.replace("namespace {\n", PROF_DECL, 1), [*edits, ('extern "C" {\n', PROF_READ)])


# ---------------------------------------------------------------------------
# the previous phased kernel: S of G heads in shared memory, then the
# softmaxes, then P.V, mma.sync from cp.async copies
# ---------------------------------------------------------------------------
PREV_PHASED_MARK = "phased_bf16_kernel(const __nv_bfloat16* __restrict__ qkv"
PP_K = "  copy_heads<G>(KV, base, rs, N, NPAD, D, h0, 1);\n  cp_async_wait<0>();\n  __syncthreads();\n"
PP_B1 = "  __syncthreads();  // every warp is done with K\n"
PP_B2 = "  cp_async_wait<0>();\n  __syncthreads();  // V has landed, for every thread\n"
PP_END = "  }\n}\n\ntemplate <int G>\ncudaError_t launch"
PREV_PHASED_SECTIONS = ("K copy and wait", "phase 1 (S)", "barrier after phase 1",
                        "phase 2 (softmax, V copies issued)", "V wait and barrier",
                        "phase 3 (P.V, store)")


def _prev_phased_sections(src: str) -> str:
    return _profiled(src, [
        (PP_K, "  const long long p0 = clock64();\n" + PP_K + "  const long long p1 = clock64();\n"),
        (PP_B1, "  const long long p2 = clock64();\n" + PP_B1 + "  const long long p3 = clock64();\n"),
        (PP_B2, "  const long long p4 = clock64();\n" + PP_B2 + "  const long long p5 = clock64();\n"),
        (PP_END, "  }\n" + _atomics(["p1 - p0", "p2 - p1", "p3 - p2", "p4 - p3", "p5 - p4",
                                     "clock64() - p5"])
         + "}\n\ntemplate <int G>\ncudaError_t launch"),
    ])


# ---------------------------------------------------------------------------
# the previous batched kernel: 4 warps walk every head, cp.async double
# buffer, the context through a [64, D] tile
# ---------------------------------------------------------------------------
PREV_BATCHED_MARK = "attend_heads_to_ctx<KT, 1, STAGES>"
PB_LOOP = "  issue(0);\n  for (int i = 0; i < groups; ++i) {\n"
PB_ISSUE = "      issue(i + 1);\n"
PB_LANDED = "    __syncthreads();  // group i's K and V have landed, for every thread\n"
PB_ATTEND = ("      attend_rows_bf16<KT, true>(o, base + h * HD, rs, Ks, Ks + NPAD * KS, mrow, N, "
             "q0 + mt * 16,\n                                 scale, g, t);\n")
PB_FREE = "    __syncthreads();  // this stage's buffers are no longer read\n"
PB_FN_END = "  }\n}\n\n// shared memory of a launch"
PB_CALL = "  attend_heads_to_ctx<KT, 1, STAGES>(ctx, kv, base, rs, mrow, N, H, q0, rows, scale);\n"
PB_KERNEL_END = "        *reinterpret_cast<const uint4*>(ctx + r * CS + c);\n  }\n}\n"
PB_TILE_STORE = """      __nv_bfloat16* c0 = ctx + (mt * 16 + g) * CS + h * HD + t * 2;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(c0 + dt * 8) = __floats2bfloat162_rn(o[dt][0], o[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(c0 + 8 * CS + dt * 8) =
            __floats2bfloat162_rn(o[dt][2], o[dt][3]);
      }
"""
PREV_BATCHED_SECTIONS = ("issuing copies", "copy waits and barrier", "attend_rows_bf16",
                         "context into the tile", "barrier after a head", "context store")


def _tick(acc: str) -> str:
    return f"    c1_ = clock64();\n    {acc} += c1_ - c0_;\n    c0_ = c1_;\n"


def _prev_batched_sections(src: str) -> str:
    return _profiled(src, [
        (PB_LOOP, "  long long t_issue = 0, t_wait = 0, t_attend = 0, t_tile = 0, t_bar = 0;\n"
         "  long long c0_ = clock64(), c1_;\n  issue(0);\n" + _tick("t_issue")
         + "  for (int i = 0; i < groups; ++i) {\n"),
        (PB_ISSUE, PB_ISSUE + _tick("t_issue")),
        (PB_LANDED, PB_LANDED + _tick("t_wait")),
        (PB_ATTEND, PB_ATTEND + _tick("t_attend")),
        (PB_FREE, _tick("t_tile") + PB_FREE + _tick("t_bar")),
        (PB_FN_END, "  }\n" + _atomics(["t_issue", "t_wait", "t_attend", "t_tile", "t_bar"])
         + "}\n\n// shared memory of a launch"),
        (PB_CALL, PB_CALL + "  const long long k1_ = clock64();\n"),
        (PB_KERNEL_END, PB_KERNEL_END[:-2] + _atomics(["clock64() - k1_"], first=5) + "}\n"),
    ])


def _prev_batched_no_tile(src: str, stages: int = 2) -> str:
    i = src.index("  __nv_bfloat16* orow = out")
    j = src.index(PB_KERNEL_END, i)
    src = src[:i] + "}\n" + src[j + len(PB_KERNEL_END):]
    return _edit(src, [
        (PB_TILE_STORE, "      store_rows(ctx + h * HD, D, o, mt * 16, rows, g, t);\n"),
        ("  unsigned char* kv = smem_raw + ctx_tile_bytes(D);\n", "  unsigned char* kv = smem_raw;\n"),
        (PB_CALL, PB_CALL.replace("(ctx, kv,", "(out + ((long)b * N + q0) * D, kv,")),
        ("  return ctx_tile_bytes(H * HD) + STAGES * kv_rows_bytes(npad);",
         "  return STAGES * kv_rows_bytes(npad);"),
        ("constexpr int STAGES = 2;", f"constexpr int STAGES = {stages};"),
        ("__launch_bounds__(THREADS, 1)", f"__launch_bounds__(THREADS, {3 if stages == 1 else 1})"),
    ])


# ---------------------------------------------------------------------------
# the committed kernels: warpgroups on the wgmma core of wgmma_attention.cuh,
# which a variant inlines so that it can edit it
# ---------------------------------------------------------------------------
CORE = CSRC / "wgmma_attention.cuh"
CORE_MARK = '#include "wgmma_attention.cuh"\n'
C_LOOP = "  for (int it = 0; it < L.items; ++it) {\n"
C_WAIT_QK = "    for (int k = 0; k <= nblk; ++k) wait_box(L, m0 + k);\n"
C_TURN = "    turns.acquire();\n"
C_ISSUED = "    wgmma_commit();\n    turns.release();\n"
C_S_FREE = "    refill(m0 + 1 + nblk);\n"
C_P_DONE = "    for (int kc = 0; kc < KT; ++kc) fence_operand(p[kc]);\n"
C_WAIT_V = "    for (int k = 1 + nblk; k < per; ++k) wait_box(L, m0 + k);\n"
C_V_FREE = "    refill(m0 + per);\n"
C_END = "            __floats2bfloat162_rn(o[4 * i + 2], o[4 * i + 3]);\n    }\n  }\n}\n"
SECTIONS = ("waits for q and K", "turn for S", "S issued", "S done, its boxes refilled",
            "softmax and P packed", "waits for V", "turn for P.V", "P.V issued",
            "P.V done, its boxes refilled", "context stores",
            "of which the first item's")


def _inline_core(src: str, prefix: str = "") -> str:
    return _edit(src, [(CORE_MARK, prefix + CORE.read_text().replace("#pragma once\n", "", 1))])


def _sections(src: str) -> str:
    """clock64 ticks of thread 0 (warpgroup 0) through each item of the core"""
    acc = [f"t{i}" for i in range(len(SECTIONS))]
    src = _inline_core(src, PROF_DECL.split("namespace")[0])
    i = src.index(C_LOOP)
    head, body = src[:i], src[i:]
    ticks = [C_WAIT_QK, C_TURN, C_ISSUED, C_S_FREE, C_P_DONE, C_WAIT_V, C_TURN, C_ISSUED, C_V_FREE]
    out, rest = "", body
    for k, anchor in enumerate(ticks):  # in order: each anchor's next occurrence
        j = rest.index(anchor) + len(anchor)
        tick = _tick(acc[k])
        if k == 0:  # the first item's wait is also counted on its own
            tick += f"    if (it == 0) {acc[-1]} += c1_ - c0_prev_;\n"
            tick = "    const long long c0_prev_ = c0_;\n" + tick
        out, rest = out + rest[:j] + tick, rest[j:]
    body = _edit(out + rest, [
        (C_LOOP, "  long long " + ", ".join(f"{a} = 0" for a in acc)
         + ";\n  long long c0_ = clock64(), c1_;\n" + C_LOOP),
        (C_END, C_END[:-8] + "    }\n" + _tick(acc[9]) + "  }\n"
         + _atomics(acc, who="threadIdx.x == 0") + "}\n"),
    ])
    return _edit(head + body, [('extern "C" {\n', PROF_READ)])


C_LOAD = "    tma_load_3d(dst, map, bar, part * D + h * HD, row, b);\n"  # FusedQkv::load
C_SOFTMAX_START = "    if (warp_live) {\n"
C_SOFTMAX_END = "    } else {\n"
C_NO_SOFTMAX = """    if (warp_live) {
#pragma unroll
      for (int i = 0; i < 2 * KT; ++i) {
        p[i / 2][2 * (i % 2)] = pack_bf16x2(s[4 * i], s[4 * i + 1]);
        p[i / 2][2 * (i % 2) + 1] = pack_bf16x2(s[4 * i + 2], s[4 * i + 3]);
      }
"""


C_S_BLOCK = "    s_block<KT, {j}>(s, qd, desc_sw128(k_box({j})));\n"
C_PV_MMA = ("    for (int kc = 0; kc < KT; ++kc)\n      WgmmaRS<64, 1>::mma(o, p[kc], "
            "desc_add(desc_sw128_mn(v_box(kc / 4)), (kc % 4) * 2048),\n                          "
            "kc > 0);\n")


def _early_issue(src: str) -> str:
    """each product issued as soon as its own boxes have landed: q and K's
    first block before S, then each K block before its S block; each V
    block before its k16 steps of P.V (the same function)"""
    src = _inline_core(src)
    edits = [(C_WAIT_QK, "    for (int k = 0; k <= 1; ++k) wait_box(L, m0 + k);\n"),
             (C_WAIT_V, "")]
    edits += [(C_S_BLOCK.format(j=j), f"    if ({j} < nblk) wait_box(L, m0 + 1 + {j});\n"
               + C_S_BLOCK.format(j=j)) for j in (1, 2, 3)]
    body = C_PV_MMA.split("\n", 1)[1]
    edits.append((C_PV_MMA, "    for (int kc = 0; kc < KT; ++kc) {\n      if (kc % 4 == 0 && kc / 4 < nblk) "
                  "wait_box(L, m0 + 1 + nblk + kc / 4);\n" + body + "    }\n"))
    return _edit(src, edits)


def _l2_only(src: str) -> str:
    """every load from batch element 0: the same boxes for every CTA, so
    they come from L2 (not the same function)"""
    src = _inline_core(src)
    return _edit(src, [(C_LOAD, C_LOAD.replace(", b);", ", 0);"))])


def _no_softmax(src: str) -> str:
    """P = S rounded, no softmax (not the same function)"""
    src = _inline_core(src)
    i = src.index(C_SOFTMAX_START)
    j = src.index(C_SOFTMAX_END, i)
    return src[:i] + C_NO_SOFTMAX + src[j:]


C_EXPECT = "  mbar_arrive_expect_tx(bar, BOX);\n"


def _kv_once(src: str) -> str:
    """K and V loaded only by the CTAs of the first query tile; the others
    attend over whatever their slots hold: the loads that sharing K and V
    between the query tiles of a head would save (not the same function)"""
    src = _inline_core(src)
    return _edit(src, [(C_EXPECT, "  if (k != 0 && L.q0 > 0) {\n    mbar_arrive(bar);\n"
                                  "    return;\n  }\n" + C_EXPECT)])


# variants that do not compute the function, so their output is not checked
OTHER_FUNCTION = ("l2_only", "no_softmax", "kv_once")
NEW_VARIANTS = {"kernel": lambda s: s, "sections": _sections, "early_issue": _early_issue,
                "l2_only": _l2_only, "no_softmax": _no_softmax, "kv_once": _kv_once}

KINDS = {
    "prev_phased": (PREV_PHASED_MARK, {"kernel": lambda s: s, "sections": _prev_phased_sections},
                    PREV_PHASED_SECTIONS),
    "prev_batched": (PREV_BATCHED_MARK, {
        "kernel": lambda s: s, "sections": _prev_batched_sections,
        "no_tile": _prev_batched_no_tile,
        "no_tile_1stage": lambda s: _prev_batched_no_tile(s, stages=1)}, PREV_BATCHED_SECTIONS),
    "phased": ("phased_bf16_kernel<W, KT>", NEW_VARIANTS, SECTIONS),
    "batched": ("batched_bf16_kernel<KT>", NEW_VARIANTS, SECTIONS),
}


def warpgroups(G: int) -> int:
    """the phased kernel's consumer warpgroups for G heads a CTA"""
    return G if G <= 3 else 3 if G % 3 == 0 else 2


def kind_of(src: str) -> str:
    for kind, (mark, _, _) in KINDS.items():
        if mark in src:
            return kind
    raise RuntimeError("exp_flash_sched: not a source this harness knows")


def variants_of(src: str) -> tuple:
    """(kind, {name: edited source}, section names)"""
    kind = kind_of(src)
    _, table, sections = KINDS[kind]
    return kind, {name: edit(src) for name, edit in table.items()}, sections


def include_flags(name: str, includes: dict | None) -> list:
    """nvcc's include path for variant `name`: the directory `includes`
    gives it (the FILE it was read from, whose commit's headers lie beside
    it), then `csrc/`"""
    first = (includes or {}).get(name)
    return (["-I", str(first)] if first is not None else []) + ["-I", str(CSRC)]


def build(sources: dict, subdir: str = "exp_flash_sched", includes: dict | None = None) -> dict:
    """One nvcc per variant, all together, into build_dir()/subdir → {name:
    (its CDLL, nvcc's log)}; `includes` maps a variant to the directory
    searched for its headers ahead of `csrc/`."""
    out = build_dir() / subdir
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, *include_flags(name, includes), "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        libs[name] = (ctypes.CDLL(str(out / f"{name}.so")), log)
    return libs


class Variant:
    """One built variant of a schedule's source and its entry point."""

    def __init__(self, schedule: str, lib: ctypes.CDLL):
        self.schedule, self.lib = schedule, lib
        if schedule == "phased":
            self.fn = lib.clibd_flash_attention_qkv_phased
            self.fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            lib.clibd_flash_phased_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.clibd_flash_phased_smem_bytes.restype = ctypes.c_long
        else:
            self.fn = lib.clibd_flash_attention_qkv_batched
            self.fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def group(self, N: int, limit: int) -> int:
        """the phased kernel's largest head group that fits `limit`"""
        for G in range(H, 0, -1):
            if 0 < self.lib.clibd_flash_phased_smem_bytes(N, H, G) <= limit:
                return G
        raise RuntimeError(f"no head group fits N={N}")

    def __call__(self, qkv, mask, out, G: int = 0) -> None:
        args = [qkv.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
                qkv.shape[0], qkv.shape[1], H]
        rc = self.fn(*args, *([G] if self.schedule == "phased" else []),
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# the phased backward: the committed kernel (wgmma on TMA-loaded operands)
# and the previous one (mma.sync from cp.async copies)
# ---------------------------------------------------------------------------
BWD_SOURCE = CSRC / "flash_attention_qkv_bwd_phased.cu"
BWD_CORE = CSRC / "wgmma_attention_bwd.cuh"  # the whole-row core the sources include
BWD_START = "  __nv_bfloat16* dg = dqkv + (long)b * N * rs + h * HD;\n"  # both kinds
PREV_BWD_MARK = "mma_kmajor_swz(dv, pa, buf1, qt * 16, lane);"
PBW_STAGED = ("  copy_tile(buf1, qg + 2 * D, rs, N);\n  cp_async_commit();\n  cp_async_wait<0>();\n"
              "  __syncthreads();\n")
PBW_ROWS = "  __syncthreads();  // K and V are no longer read; Pb and dS are complete\n"
PBW_COPIED = ("  copy_tile(buf1, og, D, N);\n  cp_async_commit();\n  cp_async_wait<0>();\n"
              "  __syncthreads();\n")
PBW_END = "    store_rows(dg + 2 * D, rs, dv, ct * 16, N, g, t);\n  }\n}\n"
PREV_BWD_SECTIONS = ("K/V staged (issue, wait, barrier)", "row phase", "barrier after it",
                     "Q/dO copy and wait", "column phase")
BWD_MARK = '#include "wgmma_attention_bwd.cuh"\n'  # the core, inlined by a variant
BW_KV = "  mbar_wait(bars + BAR_KV, 0);\n"
BW_ROWS = "  fence_proxy_async();  // Pb and dS, visible to the column phase's wgmma\n"
BW_BARRIER = "  __syncthreads();      // and K and V no longer read\n"
BW_COL = "  mbar_wait(bars + BAR_COL, 0);\n"
BW_END = "    column_block<KT>(pbds, tile0, tile1, dg + D, dg + 2 * D, rs, kb, N);\n}\n"
# row_block, through each query block of warpgroup 0: (anchor, where the
# tick goes: after it, before it, or both)
RB_START = "  const int r0 = qb * 64 + warp * 16 + lane / 4, r1 = r0 + 8;  // this thread's rows\n"
RB_END = "  store_acc(dq, rs, acc, qb * 64, N);\n}\n"
RB_TICKS = (("  mbar_wait(bar, 0);\n", "after"),
            ("  wgmma_wait<0>();\n  fence_operand(p);\n", "after"),
            ("  // ---- dP = dO.V^T", "before"),
            ("  wgmma_wait<0>();\n  fence_operand(dp);\n", "after"),
            ("  named_barrier(BAR_WG + wg, 128);  // every warp's products have read q and dO\n",
             "both"),
            ("  // ---- dQ = dS.K", "before"))
BWD_SECTIONS = ("loads issued, key row, K/V wait", "row phase", "barrier after it", "Q/dO wait",
                "column phase") + tuple(f"block: {s}" for s in (
                    "q/dO wait", "S", "softmax", "dP", "rowsum, dS and Pb", "warpgroup barrier",
                    "Pb/dS stores", "dQ and its store"))


def _stamps(names) -> str:
    return "".join(f"  const long long {n} = clock64();\n" for n in names)


def _prev_bwd_sections(src: str) -> str:
    return _profiled(src, [
        (BWD_START, BWD_START + _stamps(["p0"])),
        (PBW_STAGED, PBW_STAGED + _stamps(["p1"])),
        (PBW_ROWS, _stamps(["p2"]) + PBW_ROWS + _stamps(["p3"])),
        (PBW_COPIED, PBW_COPIED + _stamps(["p4"])),
        (PBW_END, PBW_END[:-2] + _atomics(["p1 - p0", "p2 - p1", "p3 - p2", "p4 - p3",
                                            "clock64() - p4"]) + "}\n"),
    ])


def _row_tick(k: int) -> str:
    return ("  c1_ = clock64();\n  if (threadIdx.x == 0) atomicAdd(g_prof + "
            f"{k}, (unsigned long long)(c1_ - c0_));\n  c0_ = c1_;\n")


def _inline_bwd_core(src: str, prefix: str = "") -> str:
    """the whole-row backward core (`csrc/wgmma_attention_bwd.cuh`) inlined
    into a source that includes it, after `prefix`"""
    core = BWD_CORE.read_text().replace("#pragma once\n", "", 1)
    return _edit(src, [(BWD_MARK, prefix + core)])


def _bwd_sections(src: str) -> str:
    """clock64 ticks of thread 0 in the whole-row core (inlined): the
    kernel's five stretches in g_prof[0..4], warpgroup 0's query blocks in
    g_prof[5..12] and their count in g_prof[13]"""
    src = _inline_bwd_core(src, PROF_DECL.split("namespace")[0])
    edits = [(BWD_START, BWD_START + _stamps(["p0"])),
             (BW_KV, BW_KV + _stamps(["p1"])),
             (BW_ROWS, _stamps(["p2"]) + BW_ROWS),
             (BW_BARRIER, BW_BARRIER + _stamps(["p3"])),
             (BW_COL, BW_COL + _stamps(["p4"])),
             (BW_END, BW_END[:-2] + _atomics(["p1 - p0", "p2 - p1", "p3 - p2", "p4 - p3",
                                              "clock64() - p4"]) + "}\n"),
             (RB_START, RB_START + "  long long c0_ = clock64(), c1_;\n")]
    k = 5
    for anchor, where in RB_TICKS:
        before = _row_tick(k) if where != "after" else ""
        k += where != "after"
        after = _row_tick(k) if where != "before" else ""
        k += where != "before"
        edits.append((anchor, before + anchor + after))
    edits.append((RB_END, RB_END[:-2] + _row_tick(k)
                   + "  if (threadIdx.x == 0) atomicAdd(g_prof + 13, 1ull);\n}\n"))
    return _edit(src, edits + [('extern "C" {\n', PROF_READ)])


def bwd_variants(src: str) -> tuple:
    """(kind, {name: source}, section names) of a backward source: `kernel`
    as it is and `sections` for the committed and the previous kernel; a
    source of neither kind is built as it is, with no sections"""
    if BWD_MARK in src:
        return "bwd", {"kernel": src, "sections": _bwd_sections(src)}, BWD_SECTIONS
    if PREV_BWD_MARK in src:
        return "prev_bwd", {"kernel": src, "sections": _prev_bwd_sections(src)}, PREV_BWD_SECTIONS
    return "other", {"kernel": src}, ()


def _report_ptxas(libs: dict) -> None:
    for name, (_, log) in libs.items():
        lines = log.splitlines()
        for line in lines:
            if "registers" in line or "spill" in line or "C7510" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
        injected = sum("C7519" in line for line in lines)
        if injected:
            print(f"  ptxas {name}: {injected} warpgroup.arrive injected (C7519)", flush=True)


def _inputs(N: int, masked: bool, g, dev):
    qkv = torch.randn(B, N, 3 * H * 64, generator=g, device=dev).to(torch.bfloat16)
    mask = None
    if masked:
        keep = torch.rand(B, N, generator=g, device=dev) > 0.3
        keep[:, 0] = True
        mask = (~keep).float() * torch.finfo(torch.float32).min
    return qkv, mask


def _interleaved(runs: dict) -> dict:
    times = {n: [] for n in runs}
    for n in list(runs) + list(runs)[::-1]:
        times[n].append(cuda_ms(runs[n]))
    return times


def run_bwd(paths, card: str) -> None:
    """Every backward source's variants at SHAPES: checked, timed beside v0
    and SDPA's backward, and the sections variants' clock64 profile."""
    texts, kinds, includes = {}, {}, {}
    for i, path in enumerate(paths):
        kind, variants, names = bwd_variants(path.read_text())
        kinds[f"bwd{i}"] = (kind, names)
        texts.update({f"bwd{i}_{n}": text for n, text in variants.items()})
        includes.update({f"bwd{i}_{n}": path.parent for n in variants})
    libs = build(texts, includes=includes)
    _report_ptxas(libs)
    fns = {}
    for name, (lib, _) in libs.items():
        fn = lib.clibd_flash_attention_qkv_bwd_phased
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[name] = fn

    def call(fn, qkv, dout, mask, out):
        rc = fn(qkv.data_ptr(), dout.data_ptr(), None if mask is None else mask.data_ptr(),
                out.data_ptr(), B, qkv.shape[1], H, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    D = H * 64
    for N, masked in SHAPES:
        qkv, mask = _inputs(N, masked, g, dev)
        dout = torch.randn(B, N, D, generator=g, device=dev).to(torch.bfloat16)
        out = torch.empty_like(qkv)
        m8 = None if mask is None else mask[:8]
        want = flash_attention_qkv_bwd_reference(qkv[:8], dout[:8], H, m8).float()
        runs = {}
        for n, fn in fns.items():
            if n.endswith("_sections"):
                continue
            out.zero_()
            call(fn, qkv, dout, mask, out)
            torch.cuda.synchronize()
            got = out[:8].float()
            rel = [float((got[..., i * D:(i + 1) * D] - want[..., i * D:(i + 1) * D]).abs().max())
                   / float(want[..., i * D:(i + 1) * D].abs().max()) for i in range(3)]
            print(f"N={N} mask={masked} {n}: max|variant - plain| / max|plain| on 8 rows, dq "
                  f"{rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e}", flush=True)
            runs[n] = lambda fn=fn: call(fn, qkv, dout, mask, out)
        runs["v0 (backward kernel)"] = lambda: flash_attention_qkv_bwd_cuda(qkv, dout, H, mask)
        leaf = qkv.detach().requires_grad_()
        lib_out = sdpa(leaf, H, mask)
        lib_grad = dout.view(B, N, H, 64).transpose(1, 2)
        runs["sdpa backward"] = lambda: torch.autograd.grad(lib_out, leaf, lib_grad,
                                                            retain_graph=True)
        print(f"backward B={B} H={H} N={N} mask={masked}, ms  [{card}]", flush=True)
        for n, ts in _interleaved(runs).items():
            print(f"  {n:28s} {', '.join(f'{t:.4f}' for t in ts)}", flush=True)
        for prefix, (kind, names) in kinds.items():
            if not names:
                continue
            lib = libs[f"{prefix}_sections"][0]
            prof = (ctypes.c_ulonglong * 16)()
            lib.clibd_prof.argtypes = [ctypes.c_void_p]
            lib.clibd_prof(ctypes.addressof(prof))
            call(fns[f"{prefix}_sections"], qkv, dout, mask, out)
            torch.cuda.synchronize()
            lib.clibd_prof(ctypes.addressof(prof))
            print(f"  clock64 sections of {prefix} ({kind}), thread 0, cycles a CTA: " + ", ".join(
                f"{s} {prof[i] / (B * H):.0f}" for i, s in enumerate(names[:5])), flush=True)
            if len(names) > 5:
                blocks = max(prof[13], 1)
                print(f"  ... and a query block of warpgroup 0 ({blocks} blocks): " + ", ".join(
                    f"{s[7:]} {prof[5 + i] / blocks:.0f}" for i, s in enumerate(names[5:])),
                    flush=True)
        del qkv, mask, dout, out, leaf, lib_out, lib_grad
        torch.cuda.empty_cache()


def run_forward(args, card: str) -> None:
    sections, sources, includes = {}, {}, {}
    for schedule, path in (("phased", args.phased), ("batched", args.batched)):
        kind, variants, names = variants_of(path.read_text())
        sections[schedule] = (kind, names)
        sources.update({f"{schedule}_{n}": text for n, text in variants.items()})
        includes.update({f"{schedule}_{n}": path.parent for n in variants})
    libs = build(sources, includes=includes)
    _report_ptxas(libs)
    dev = torch.device("cuda")
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    variants = {name: Variant(name.split("_", 1)[0], lib) for name, (lib, _) in libs.items()}
    g = torch.Generator(device=dev).manual_seed(0)
    for N, masked in SHAPES:
        qkv, mask = _inputs(N, masked, g, dev)
        out = torch.empty(B, N, H * 64, device=dev, dtype=torch.bfloat16)
        want = flash_attention_qkv_reference(qkv[:8], H, None if mask is None else mask[:8]).float()
        groups = {n: (v.group(N, limit) if v.schedule == "phased" else 0)
                  for n, v in variants.items()}
        runs = {}
        for n, v in variants.items():
            if n.endswith("_sections"):
                continue
            out.zero_()
            v(qkv, mask, out, groups[n])
            torch.cuda.synchronize()
            if not n.endswith(OTHER_FUNCTION):
                err = float((out[:8].float() - want).abs().max())
                print(f"N={N} mask={masked} {n} (G={groups[n]}): max|variant - plain| on 8 rows "
                      f"{err:.3e}", flush=True)
            runs[n] = lambda v=v, G=groups[n]: v(qkv, mask, out, G)
            if n == "phased_kernel" and not sections["phased"][0].startswith("prev_"):
                for G in PHASED_GROUPS:  # the committed kernel takes every group
                    runs[f"{n} G={G}"] = lambda v=v, G=G: v(qkv, mask, out, G)
        runs["v0 (forward kernel)"] = lambda: flash_attention_qkv_cuda(qkv, H, mask)
        runs["sdpa"] = lambda: sdpa(qkv, H, mask)
        times = _interleaved(runs)
        print(f"B={B} H={H} N={N} mask={masked}, ms  [{card}]", flush=True)
        for n, ts in times.items():
            print(f"  {n:28s} {', '.join(f'{t:.4f}' for t in ts)}", flush=True)
        for schedule, (kind, names) in sections.items():
            v = variants[f"{schedule}_sections"]
            prof = (ctypes.c_ulonglong * 16)()
            v.lib.clibd_prof.argtypes = [ctypes.c_void_p]
            v.lib.clibd_prof(ctypes.addressof(prof))
            v(qkv, mask, out, groups[f"{schedule}_sections"])
            torch.cuda.synchronize()
            v.lib.clibd_prof(ctypes.addressof(prof))
            G = groups[f"{schedule}_sections"] or H
            ctas = B * -(-N // 64) * (H // G if schedule == "phased" else 1)
            per = "a CTA"
            if not kind.startswith("prev_"):  # warpgroup 0's items: its heads
                ctas *= -(-G // warpgroups(G)) if schedule == "phased" else -(-H // 3)
                per = "an item of warpgroup 0"
            print(f"  clock64 sections of {kind} (G={G}), thread 0, cycles {per}: " + ", ".join(
                f"{s} {prof[i] / ctas:.0f}" for i, s in enumerate(names)), flush=True)
        del qkv, mask, out
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# row 1, the main path's forward (csrc/flash_attention_qkv.cu): every CTA
# shape at the main path's four shapes, B=500
# ---------------------------------------------------------------------------
ROW1_SOURCE = CSRC / "flash_attention_qkv.cu"
ROW1_SHAPES = (("vit", 197, 12, False), ("barcode_bert", 133, 12, False),
               ("bert_small", 20, 8, True), ("barcode_bert_overlap", 657, 12, True))
ROW1_B = 500
R1_SOFTMAX = "  __device__ __forceinline__ void softmax(int j, float& al0, float& al1) {\n"
R1_BLOCK = """    if (j > 0) cta.next_keys(j);
    cta.wait_k(j);
    fence_operand(s);
    wgmma_fence();
    issue_s(j);
    wgmma_commit();
    if (j > 0)
      cta.release(j - 1);
    else
      cta.next_q();
    wgmma_wait<0>();
    fence_operand(s);
    if (live) {
      float al0, al1;
      softmax<WIDTH>(j, al0, al1);
      rescale_pack<WIDTH>(al0, al1);
    }
    fence_pv();
    cta.wait_v(j);
    wgmma_fence();
    issue_pv<WIDTH>(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_pv();
    if (j == cta.nblk - 1) cta.release(j);
"""
# the line of R1_BLOCK after which each section's tick goes
R1_TICKS = {"    cta.wait_k(j);\n": 2, "      cta.next_q();\n": 7, "    wgmma_wait<0>();\n": 3,
            "    fence_pv();\n": 4, "    cta.wait_v(j);\n": 5,
            "    if (j == cta.nblk - 1) cta.release(j);\n": 7}
R1_TILE_STATE = "  float m0, m1, l0, l1;\n"
R1_ITEM = "  for (int k = 0; k < count; ++k) {\n"
R1_Q_WAIT = "    mbar_wait(qfull + (k % 2) * W + wg, (k / 2) & 1);\n"
R1_STORE = "    // the context, bf16, through the q box"
R1_ITEM_END = "        tma_store_commit();\n      }\n    }\n  }\n"
R1_KERNEL_END = "  if (tw == 0) tma_store_wait_read();  // the boxes stay"
ROW1_SECTIONS = ("item set-up", "wait for q", "waits for K", "S", "softmax, P packed",
                 "waits for V", "P.V", "slots released, next q loaded", "context stored")


def _row1_sections(src: str) -> str:
    """clock64 ticks of thread 0 through each item of the one-product-at-a-
    time loop (block<>), summed in registers and added to g_prof once a
    CTA: the item's set-up (the key row where it is staged), the wait for
    q, and per key block the wait for K, S, the softmax, the wait for V,
    P.V, and the release of a slot or the next item's q load, then the
    context's store"""
    ticked, seen = "", set()
    for line in R1_BLOCK.splitlines(keepends=True):
        ticked += line
        k = R1_TICKS.get(line)
        if line == "    wgmma_wait<0>();\n" and line in seen:
            k = 6  # the second wait is P.V's
        if line == "    fence_pv();\n" and line in seen:
            k = None  # the second fence follows P.V's wait
        seen.add(line)
        if k is not None:
            ticked += f"    TICK_({k})\n"
    src = _profiled(src, [
        (R1_BLOCK, ticked),
        (R1_TILE_STATE, R1_TILE_STATE + "  long long* prof_;\n  long long c0_;\n"),
        (R1_ITEM, "  long long prof_[9] = {};\n" + R1_ITEM + "    const long long i0_ = clock64();\n"),
        (R1_Q_WAIT, "    tile.prof_ = prof_;\n    tile.c0_ = clock64();\n    prof_[0] += tile.c0_ - i0_;\n"
         + R1_Q_WAIT + "    prof_[1] += clock64() - tile.c0_;\n    tile.c0_ = clock64();\n"),
        (R1_STORE, "    const long long k9_ = clock64();\n" + R1_STORE),
        (R1_ITEM_END, R1_ITEM_END[:-4] + "    prof_[8] += clock64() - k9_;\n  }\n"),
        (R1_KERNEL_END, "  if (threadIdx.x == 0) {\n#pragma unroll\n    for (int i = 0; i < 9; ++i)\n"
                        "      atomicAdd(g_prof + i, (unsigned long long)prof_[i]);\n  }\n"
         + R1_KERNEL_END),
    ])
    tick = ("#define TICK_(k) { const long long c1_ = clock64(); prof_[k] += c1_ - c0_; "
            "c0_ = c1_; }\n")
    return src.replace(PROF_DECL, PROF_DECL + tick, 1)


ROW1_VARIANTS = {
    "kernel": lambda s: s,
    # clock64 sections of thread 0 (the same function)
    "sections": _row1_sections,
    # every load from batch element 0, so from L2 (not the same function)
    "l2_only": _l2_only,
    # P = S rounded: no max, no exponentials, no row sums (not the same function)
    "no_softmax": lambda s: _edit(s, [(R1_SOFTMAX, R1_SOFTMAX + "    al0 = al1 = 1.f;\n    return;\n")]),
}


ROW1_WARPGROUPS = (1, 2, 4)  # the kernel's CTA shapes: consumer warpgroups a CTA


def _row1_entry(lib: ctypes.CDLL, by_w: bool):
    fn = lib.clibd_flash_attention_qkv_fwd_w if by_w else lib.clibd_flash_attention_qkv_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def run_row1(paths, card: str) -> None:
    """The committed forward at every CTA shape (ROW1_WARPGROUPS, through
    `clibd_flash_attention_qkv_fwd_w`), its `l2_only` and `no_softmax`
    variants at the shape it picks (`clibd_flash_fwd_warpgroups`), and each
    other source in `paths` as it is (an earlier version of the file): each
    checked on the first 8 batch rows where it computes the function, then
    timed twice, interleaved, beside v0 (the wrapper) and SDPA; then the
    `sections` variant's clock64 cycles an item at the picked shape."""
    texts = {f"row1_{n}": edit(ROW1_SOURCE.read_text()) for n, edit in ROW1_VARIANTS.items()}
    for i, path in enumerate(paths):
        texts[f"other{i}"] = path.read_text()
    libs = build(texts, "exp_flash_sched_row1",
                 includes={f"other{i}": path.parent for i, path in enumerate(paths)})
    _report_ptxas(libs)
    lib = libs["row1_kernel"][0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    for name, N, heads, masked in ROW1_SHAPES:
        qkv = torch.randn(ROW1_B, N, 3 * heads * 64, generator=g, device=dev).to(torch.bfloat16)
        mask = None
        if masked:
            keep = torch.rand(ROW1_B, N, generator=g, device=dev) > 0.3
            keep[:, 0] = True
            mask = (~keep).float() * torch.finfo(torch.float32).min
        out = torch.empty(ROW1_B, N, heads * 64, device=dev, dtype=torch.bfloat16)
        want = flash_attention_qkv_reference(qkv[:8], heads,
                                             None if mask is None else mask[:8]).float()

        def call(fn, *w):
            rc = fn(qkv.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
                    ROW1_B, N, heads, *w, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        runs, chosen = {}, lib.clibd_flash_fwd_warpgroups(N)
        for w in ROW1_WARPGROUPS:
            runs[f"kernel W={w}" + (" (picked)" if w == chosen else "")] = (
                lambda w=w: call(_row1_entry(lib, True), w))
        for v in ROW1_VARIANTS:
            if v not in ("kernel", "sections"):
                runs[f"{v} W={chosen}"] = (
                    lambda v=v: call(_row1_entry(libs[f"row1_{v}"][0], True), chosen))
        for i in range(len(paths)):
            runs[f"other{i} ({paths[i].name})"] = (
                lambda i=i: call(_row1_entry(libs[f"other{i}"][0], False), 1))
        for n, run in runs.items():
            if n.startswith(("kernel", "other")):
                out.zero_()
                run()
                torch.cuda.synchronize()
                err = float((out[:8].float() - want).abs().max())
                print(f"{name} N={N} {n}: max|variant - plain| on 8 rows {err:.3e}", flush=True)
        runs["v0 (forward kernel)"] = lambda: flash_attention_qkv_cuda(qkv, heads, mask)
        runs["sdpa"] = lambda: sdpa(qkv, heads, mask)
        print(f"row 1 {name} B={ROW1_B} H={heads} N={N} mask={masked}, ms  [{card}]", flush=True)
        for n, ts in _interleaved(runs).items():
            print(f"  {n:28s} {', '.join(f'{t:.4f}' for t in ts)}", flush=True)
        prof_lib = libs["row1_sections"][0]
        prof = (ctypes.c_ulonglong * 16)()
        prof_lib.clibd_prof.argtypes = [ctypes.c_void_p]
        prof_lib.clibd_prof(ctypes.addressof(prof))
        call(_row1_entry(prof_lib, True), chosen)
        torch.cuda.synchronize()
        prof_lib.clibd_prof(ctypes.addressof(prof))
        items = ROW1_B * heads * -(-N // (64 * chosen))  # of W query tiles each
        print(f"  clock64 sections at W={chosen}, thread 0, cycles an item: " + ", ".join(
            f"{sec} {prof[i] / items:.0f}" for i, sec in enumerate(ROW1_SECTIONS)), flush=True)
        del qkv, mask, out
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# row 2, the main path's backward (csrc/flash_attention_qkv_bwd.cu): each
# route at the main path's four shapes, B=500
# ---------------------------------------------------------------------------
ROW2_SOURCE = CSRC / "flash_attention_qkv_bwd.cu"
# the routes of the bf16 backward, by the number its entry point takes
ROW2_ROUTES = {"row": 0, "tiled": 1}
ROW2_WHOLE_ROW_MAX_N = 208


def row2_route(N: int) -> str:
    """The kernel's rule (`route_for` in ROW2_SOURCE): the whole row on chip
    up to 208 keys, key-tiled past them."""
    return "row" if N <= ROW2_WHOLE_ROW_MAX_N else "tiled"


# the key-tiled kernels' clock64 hooks (BWD_PROF_BEGIN, BWD_TICK(k),
# BWD_PROF_END(first) in ROW2_SOURCE): thread 0's cycles, the row kernel's
# eight sections in g_prof[0..7], the column kernel's six in [8..13]
ROW2_PROF = """__device__ unsigned long long g_prof[16];
#define BWD_PROF_BEGIN long long prof_[8] = {}; long long c0_ = clock64();
#define BWD_TICK(k) { const long long c1_ = clock64(); prof_[k] += c1_ - c0_; c0_ = c1_; }
#define BWD_PROF_END(first) if (threadIdx.x == 0) { for (int i_ = 0; i_ < 8; ++i_) \\
    atomicAdd(g_prof + (first) + i_, (unsigned long long)prof_[i_]); }
"""
ROW2_ROW_SECTIONS = ("set-up", "q/dO wait", "K/V waits", "S and dP", "online statistics",
                     "sweep 2: P and dS", "sweep 2: dQ", "statistics and dQ stores")
ROW2_COL_SECTIONS = ("K/V wait", "Q/dO waits", "S^T and dP^T", "P^T and dS^T",
                     "dV and dK products", "dK/dV stores, next K/V")


def _row2_tiled_sections(src: str) -> str:
    return _edit(ROW2_PROF + src, [('extern "C" {\n', PROF_READ)])


ROW2_VARIANTS = {
    "kernel": lambda s: s,
    # the whole-row route's sections: the core inlined, the phased
    # backward's ticks (BWD_SECTIONS)
    "sections_row": lambda s: _bwd_sections(s),
    # the key-tiled route's sections (ROW2_ROW_SECTIONS, ROW2_COL_SECTIONS)
    "sections_tiled": _row2_tiled_sections,
}


def _row2_entry(lib: ctypes.CDLL, current: bool):
    """the backward entry of a build: the committed one takes a scratch and
    a route; an earlier one (the mma.sync kernels of 1b418aa) a [B, H, 3, N]
    statistics buffer"""
    fn = lib.clibd_flash_attention_qkv_bwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * (5 if current else 4)
                   + [ctypes.c_void_p])
    return fn


def run_row2(paths, card: str) -> None:
    """The committed backward with each route forced, each other source in
    `paths` as it is (an earlier version of the file, built against the
    headers beside it): each checked on the first 8 batch rows, then timed
    twice, interleaved, beside v0 (the wrapper) and SDPA's backward; then
    the `sections` variants' clock64 cycles of each route."""
    texts = {f"row2_{n}": edit(ROW2_SOURCE.read_text()) for n, edit in ROW2_VARIANTS.items()}
    for i, path in enumerate(paths):
        texts[f"other{i}"] = path.read_text()
    libs = build(texts, "exp_flash_sched_row2",
                 includes={f"other{i}": path.parent for i, path in enumerate(paths)})
    _report_ptxas(libs)
    scratch_bytes = libs["row2_kernel"][0].clibd_flash_bwd_scratch_bytes
    scratch_bytes.argtypes = [ctypes.c_int] * 5
    scratch_bytes.restype = ctypes.c_long
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for name, N, heads, masked in ROW1_SHAPES:
        D = heads * 64
        qkv = torch.randn(ROW1_B, N, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        dout = torch.randn(ROW1_B, N, D, generator=g, device=dev).to(torch.bfloat16)
        mask = None
        if masked:
            keep = torch.rand(ROW1_B, N, generator=g, device=dev) > 0.3
            keep[:, 0] = True
            mask = (~keep).float() * torch.finfo(torch.float32).min
        out = torch.empty_like(qkv)
        want = flash_attention_qkv_bwd_reference(qkv[:8], dout[:8], heads,
                                                 None if mask is None else mask[:8]).float()
        scratch = torch.empty(scratch_bytes(ROW1_B, N, heads, 1, ROW2_ROUTES["tiled"]),
                              dtype=torch.uint8, device=dev)
        stats = torch.empty(ROW1_B, heads, 3, N, device=dev)

        def call(fn, *route, current=True):
            rc = fn(qkv.data_ptr(), dout.data_ptr(), None if mask is None else mask.data_ptr(),
                    out.data_ptr(), (scratch if current else stats).data_ptr(), ROW1_B, N,
                    heads, 1, *route, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        runs = {}
        for r, code in ROW2_ROUTES.items():
            if r == "row" and N > ROW2_WHOLE_ROW_MAX_N:
                continue
            label = f"kernel {r}" + (" (picked)" if r == row2_route(N) else "")
            runs[label] = lambda code=code: call(_row2_entry(libs["row2_kernel"][0], True), code)
        for i in range(len(paths)):
            current = "clibd_flash_bwd_route" in texts[f"other{i}"]
            runs[f"other{i} ({paths[i].name})"] = (
                lambda i=i, current=current: call(_row2_entry(libs[f"other{i}"][0], current),
                                                  *((row2_route(N),) if current else ()),
                                                  current=current))
        for n, run in runs.items():
            out.zero_()
            run()
            torch.cuda.synchronize()
            got = out[:8].float()
            rel = [float((got[..., k * D:(k + 1) * D] - want[..., k * D:(k + 1) * D]).abs().max()
                         / want[..., k * D:(k + 1) * D].abs().max()) for k in range(3)]
            print(f"{name} N={N} {n}: max|variant - plain| / max|plain| on 8 rows, dq "
                  f"{rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e}", flush=True)
        runs["v0 (backward kernel)"] = lambda: flash_attention_qkv_bwd_cuda(qkv, dout, heads, mask)
        leaf = qkv.detach().requires_grad_()
        lib_out = sdpa(leaf, heads, mask)
        lib_grad = dout.view(ROW1_B, N, heads, 64).transpose(1, 2)
        runs["sdpa backward"] = lambda: torch.autograd.grad(lib_out, leaf, lib_grad,
                                                            retain_graph=True)
        print(f"row 2 {name} B={ROW1_B} H={heads} N={N} mask={masked}, ms  [{card}]", flush=True)
        for n, ts in _interleaved(runs).items():
            print(f"  {n:28s} {', '.join(f'{t:.4f}' for t in ts)}", flush=True)
        tiles = ROW1_B * heads * -(-N // 64)
        for r, code in ROW2_ROUTES.items():
            if r == "row" and N > ROW2_WHOLE_ROW_MAX_N:
                continue
            lib = libs["row2_sections_row" if r == "row" else "row2_sections_tiled"][0]
            prof = (ctypes.c_ulonglong * 16)()
            lib.clibd_prof.argtypes = [ctypes.c_void_p]
            lib.clibd_prof(ctypes.addressof(prof))
            call(_row2_entry(lib, True), code)
            torch.cuda.synchronize()
            lib.clibd_prof(ctypes.addressof(prof))
            if r == "row":
                blocks = max(prof[13], 1)
                print(f"  clock64 sections, route row, thread 0, cycles a CTA: " + ", ".join(
                    f"{s} {prof[i] / (ROW1_B * heads):.0f}" for i, s in enumerate(BWD_SECTIONS[:5]))
                    + f"; a query block of warpgroup 0 ({blocks} blocks): " + ", ".join(
                    f"{s[7:]} {prof[5 + i] / blocks:.0f}" for i, s in enumerate(BWD_SECTIONS[5:])),
                    flush=True)
            else:
                print("  clock64 sections, route tiled, thread 0, cycles a row-kernel CTA: "
                      + ", ".join(f"{s} {prof[i] / tiles:.0f}"
                                  for i, s in enumerate(ROW2_ROW_SECTIONS))
                      + "; a column item: " + ", ".join(
                          f"{s} {prof[8 + i] / tiles:.0f}" for i, s in enumerate(ROW2_COL_SECTIONS)),
                      flush=True)
        del qkv, dout, mask, out, leaf, lib_out, lib_grad, scratch, stats
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phased", type=Path, default=SOURCES["phased"])
    parser.add_argument("--batched", type=Path, default=SOURCES["batched"])
    parser.add_argument("--bwd", type=Path, action="append", default=[])
    parser.add_argument("--row1", type=Path, nargs="*", default=None,
                        help="time row 1 alone: the committed forward's CTA shapes and "
                             "variants, and each FILE as it is")
    parser.add_argument("--row2", type=Path, nargs="*", default=None,
                        help="time row 2 alone: the committed backward's routes and their "
                             "sections, and each FILE as it is")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_flash_sched needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    if args.row1 is not None:
        run_row1(args.row1, card)
        return
    if args.row2 is not None:
        run_row2(args.row2, card)
        return
    run_forward(args, card)
    run_bwd(args.bwd or [BWD_SOURCE], card)


if __name__ == "__main__":
    main()
