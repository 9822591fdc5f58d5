"""Where the time of extraction, or of a train step, goes on one CUDA card.

    python -m clibd_tpu_torch.tools.profile_extract [--out DIR] [--experiment YAML] [--fused]
        [--no-plain]
    python -m clibd_tpu_torch.tools.profile_extract --train [--out DIR] [--experiment YAML]
        [--fused] [--no-plain] [--accum K]

Drives an experiment recipe -- by default the flagship tri-modal one
(`EXPERIMENT`: ViT-B/16, BarcodeBERT, BERT-small at full width, bf16, batch
500, no LoRA); `--experiment for_bioscan_1m/image_bind_style/
with_bioclip_bind_to_image.yaml` is the BioCLIP one -- with weights from a
seeded fresh init over `SyntheticSplit`s.  `--fused` turns on both opt-in
kernels, the attention with its out-projection fused in and the fused MLP
(`CLIBD_ATTN_FUSE_OUTPROJ=1`, `CLIBD_MLP_IMPL=pallas`).  Extraction (the
default) measures:

1. step: device ms per batch of the whole encode step and of each encoder,
   by CUDA events (median of 5 after 2 warm-up runs), with the kernels and
   with their plain versions in their place;
2. extract: samples/s through `extract_split` over `BATCHES` full
   batches, host arrays to host embeddings, in the order kernel, plain,
   plain, kernel;
3. trace: `torch.profiler` over `extract_split` of 3 batches, with the
   program's spans recorded (`utils.profiling.SpanRecorder`).  Device time
   by group, and the device's idle share read from the trace: the part of
   the traced `extract_split` span in which no kernel, copy or memset ran on
   the card.

--train measures one train step of the same recipe (remat "attn", AdamW,
the one-cycle schedule) on one batch already on the card, `--accum K` the
gradient cache's step with K microbatches (`make_train_step_accum`):

1. step: device ms per train step by CUDA events (median of 3 after 1
   warm-up step), with the kernels and with their plain versions
   in their place, in the order kernels, plain, plain, kernels; the peak
   device memory of a step;
2. trace: `torch.profiler` over `TRACE_STEPS` steps, with the program's
   spans.  Device time by group and the device's idle share inside the
   traced `train_step` span.

A group is the attention operator whose span (`attn.fwd`, `attn.bwd`,
`attn.outproj`) launched the operation (`benchmark/core/spans.py`, run from
the root of the checkout), else the kernel's name read by `KERNEL_GROUPS`.
The spans are merged into the exported trace, on its clock, so one timeline
in Perfetto shows them over the device's work.

`--no-plain` leaves out the runs with the plain versions (their timings are
then "not measured"): at the overlap-tokenizer recipe's DNA length, N=657,
their [B, H, N, N] fp32 intermediates take 10 GB each at batch 500.

Each mode writes `summary.json`, `profile_table.txt` (key_averages by device
time) and `trace.json.gz` into --out, and prints the summary as its last
line.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import tempfile
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterable, List, Optional, Tuple

EXPERIMENT = "for_bioscan_1m/final_experiments/image_dna_text_seed_42.yaml"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BATCHES = 10  # the end-to-end runs
TRACE_BATCHES = 3
TRACE_STEPS = 2
# the span that launched an operation -> its group
SPAN_GROUPS = {"attn.fwd": "attention forward", "attn.bwd": "attention backward",
               "attn.outproj": "attention + out-projection"}
# kernel name fragment -> group, first match wins, for operations no span
# of SPAN_GROUPS launched
KERNEL_GROUPS = (
    ("mlp_bf16", "fused MLP kernel"),
    ("nvjet", "gemm"), ("gemm", "gemm"), ("cutlass", "gemm"), ("xmma", "gemm"),
    ("multi_tensor", "optimizer"),
    ("copy", "casts and copies"),
)


def device_idle_share(events: Iterable[dict], window: Tuple[float, float]) -> float:
    """1 - (union of device event intervals inside `window`) / len(window),
    over chrome-trace events (`ts`, `dur` in us; `cat` in DEVICE_CATS)."""
    lo, hi = window
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events if e.get("cat") in DEVICE_CATS)
    busy, cur = 0.0, None
    for s, t in spans:
        if t <= s:
            continue
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    return 1.0 - busy / (hi - lo)


def kernel_group(name: str) -> str:
    low = name.lower()
    for frag, group in KERNEL_GROUPS:
        if frag in low:
            return group
    return "elementwise and reductions"


def device_ms_by_group(events: List[dict], window: Tuple[float, float],
                       owners: Optional[Dict[int, dict]] = None) -> Dict[str, float]:
    """Device ms inside `window` by group; `owners` maps an operation (its
    index in `events`) to the span that launched it
    (`benchmark.core.spans.Spans.owner`)."""
    lo, hi = window
    owners = owners or {}
    out: Dict[str, float] = {}
    for i, e in enumerate(events):
        if e.get("cat") not in DEVICE_CATS or not lo <= e["ts"] <= hi:
            continue
        owner = owners.get(i)
        if owner is not None and owner["name"] in SPAN_GROUPS:
            group = SPAN_GROUPS[owner["name"]]
        elif e["cat"] == "kernel":
            group = kernel_group(e["name"])
        else:
            group = "host<->device copies"
        out[group] = out.get(group, 0.0) + e["dur"] / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def trace_window(events: List[dict], name: str) -> Tuple[float, float]:
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    if not spans:
        raise RuntimeError(f"profile_extract: no '{name}' span in the trace")
    return min(s for s, _ in spans), max(t for _, t in spans)


@contextmanager
def plain_kernels():
    """Send every kernel's operator to its plain version on the card, for a
    comparison; the port itself has no such switch."""
    from ..ops import attention, layernorm, mlp

    swaps = [(attention, "_cuda_fwd", attention.flash_attention_qkv_reference),
             (attention, "_cuda_bwd", attention.flash_attention_qkv_bwd_reference),
             (attention, "_cuda_outproj", attention.flash_attention_qkv_outproj_reference),
             (mlp, "_cuda_mlp", mlp.fused_mlp_reference),
             (layernorm, "_cuda_fwd", layernorm.layernorm_stats_reference),
             (layernorm, "_cuda_bwd", layernorm.layernorm_bwd_reference)]
    saved = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), kernel in zip(swaps, saved):
            setattr(module, name, kernel)


@contextmanager
def traced(span: str):
    """`torch.profiler` (host operators and the card) over the body, inside
    a `record_function(span)` and closed by a synchronise, with the
    program's spans recorded; yields [profiler, recorder]."""
    import torch

    from ..utils.profiling import SpanRecorder

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rec = SpanRecorder()
    with torch.profiler.profile(activities=acts) as prof:
        rec.start()
        try:
            with torch.profiler.record_function(span):
                yield prof, rec
            torch.cuda.synchronize()
        finally:
            rec.stop()


def write_trace(prof, rec, out: str, span: str, runs: int) -> dict:
    """Write the profiler's table and gzipped trace, the recorder's spans
    merged in, into `out`; → the span's length, the device's idle share in
    it, device ms by group and the spans by name."""
    from collections import Counter

    from benchmark.core.spans import Spans

    with open(os.path.join(out, "profile_table.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    spans = rec.to_trace_events(trace.get("baseTimeNanoseconds", 0))
    events = trace["traceEvents"]
    window = trace_window(events, span)
    owners = Spans(events, spans).owner if spans else {}
    trace["traceEvents"] = events + spans
    with gzip.open(os.path.join(out, "trace.json.gz"), "wt") as f:
        json.dump(trace, f)
    return {"runs": runs, "span_ms": (window[1] - window[0]) / 1e3,
            "device_idle_share": device_idle_share(events, window),
            "device_ms_by_group": device_ms_by_group(events, window, owners),
            "spans": dict(Counter(e["name"] for e in spans))}


def profile_train(out: str, card: str, summary: dict, experiment: str, plain: bool,
                  accum: int = 1) -> dict:
    import torch

    from ..config import load_config
    from ..data import SyntheticSplit
    from ..engine.extract import to_device
    from ..engine.schedules import build_schedule
    from ..engine.train import batch_generator, build_optimizer, make_train_step_accum
    from ..models import init_clibd_model
    from ..utils.profiling import cuda_ms

    device = torch.device("cuda")
    mc = load_config(experiment=experiment).model_config
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    B = mc.batch_size
    batch = to_device({k: v for k, v in next(SyntheticSplit("train", B, mc, seed=0).batches())
                       .items() if k != "index"}, device)
    optimizer = build_optimizer(mc, model, build_schedule(mc.optim, 6 * mc.epochs, B))
    step = make_train_step_accum(mc, model, optimizer, accum)

    def run():
        step(batch, batch_generator(device, mc.default_seed, 0, 0))

    summary.update({"mode": "train", "batch": B, "remat": mc.remat,
                    "remat_policy": mc.remat_policy, "accum_steps": accum})
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    summary["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ms: Dict[str, List[float]] = {"kernels": [], "plain": []}
    for which in ("kernels", "plain", "plain", "kernels") if plain else ("kernels", "kernels"):
        with plain_kernels() if which == "plain" else nullcontext():
            ms[which].append(cuda_ms(run, warmup=1, iters=3))
        print(f"train step, {which}: {ms[which][-1]:.3f} ms = "
              f"{B / ms[which][-1] * 1e3:.2f} samples/s  [{card}]")
    summary["train_step_ms"] = {k: v or "not measured" for k, v in ms.items()}
    with traced("train_step") as (prof, rec):
        for _ in range(TRACE_STEPS):
            run()
    summary["trace"] = write_trace(prof, rec, out, "train_step", TRACE_STEPS)
    print(f"trace of {TRACE_STEPS} train steps: {summary['trace']}  [{card}]")
    return summary


def profile_extract(out: str, card: str, summary: dict, experiment: str, plain: bool) -> dict:
    import torch

    from ..config import load_config
    from ..data import SyntheticSplit
    from ..engine.extract import extract_split, make_encode_step, to_device
    from ..models import init_clibd_model
    from ..models.clibd import encode_dna, encode_image, encode_language
    from ..utils.profiling import cuda_ms

    device = torch.device("cuda")
    mc = load_config(experiment=experiment).model_config
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    B = mc.batch_size
    split = SyntheticSplit("profile", BATCHES * B, mc, seed=0)
    batch = to_device({k: v for k, v in next(split.batches()).items() if k != "index"}, device)
    step = make_encode_step(mc, model, torch.bfloat16)
    summary["batch"] = B

    def encoders():
        return {
            "step": lambda: step(batch),
            "image": lambda: encode_image(model, mc, batch["image"]),
            "dna": lambda: encode_dna(model, mc, batch["dna"]),
            "language": lambda: encode_language(model, mc, batch["language"]),
        }

    with torch.inference_mode():
        summary["step_ms"] = {k: cuda_ms(f, warmup=2, iters=5) for k, f in encoders().items()}
        summary["step_ms_plain"] = "not measured"
        if plain:
            with plain_kernels():
                summary["step_ms_plain"] = {k: cuda_ms(f, warmup=2, iters=5)
                                            for k, f in encoders().items()}
    print(f"device ms per batch, kernel: {summary['step_ms']}  [{card}]")
    print(f"device ms per batch, plain:  {summary['step_ms_plain']}  [{card}]")

    rates: Dict[str, List[float]] = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel") if plain else ("kernel", "kernel"):
        ctx = plain_kernels() if which == "plain" else nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            extract_split(model, mc, split)
            torch.cuda.synchronize()
            rates[which].append(BATCHES * B / (time.perf_counter() - t0))
        print(f"extract_split {BATCHES} x {B}, {which}: {rates[which][-1]:.2f} samples/s  "
              f"[{card}]")
    summary["extract_samples_per_s"] = {k: v or "not measured" for k, v in rates.items()}

    short = SyntheticSplit("trace", TRACE_BATCHES * B, mc, seed=1)
    extract_split(model, mc, short)
    with traced("extract_split") as (prof, rec):
        extract_split(model, mc, short)
    summary["trace"] = write_trace(prof, rec, out, "extract_split", TRACE_BATCHES)
    print(f"trace of {TRACE_BATCHES} batches: {summary['trace']}  [{card}]")
    return summary


def main(argv=None) -> dict:
    import torch

    from ..models.layers import kernel_knobs
    from ..utils.profiling import card_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_extract")
    ap.add_argument("--train", action="store_true", help="profile a train step instead")
    ap.add_argument("--experiment", default=EXPERIMENT, help="experiment YAML (configs/...)")
    ap.add_argument("--fused", action="store_true",
                    help="fused out-projection and fused MLP kernels on")
    ap.add_argument("--no-plain", dest="plain", action="store_false",
                    help="leave out the runs with the plain versions")
    ap.add_argument("--accum", type=int, default=1, metavar="K",
                    help="with --train: the gradient cache's step with K microbatches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_extract needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    summary: dict = {"card": card, "experiment": args.experiment, "fused": args.fused,
                     "torch": torch.__version__, "cuda": torch.version.cuda}
    with kernel_knobs(args.fused, "pallas" if args.fused else "xla"):
        if args.train:
            summary = profile_train(args.out, card, summary, args.experiment, args.plain,
                                    args.accum)
        else:
            summary = profile_extract(args.out, card, summary, args.experiment, args.plain)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
