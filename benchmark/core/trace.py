"""The traced part of a `--trace 1` run: `torch.profiler` over a fixed
number of whole steps or batches in the middle of the window, read back
into device time by kernel group, the device's busy and idle time, and
what the host was doing while the device idled.

The device groups and the busy time copy
`clibd_tpu_torch/tools/profile_extract.py`'s `KERNEL_GROUPS` and
`device_idle_share`, with the names the attention backward's kernels took
in its Hopper redesign.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel name fragment (lower case) -> group, first match wins
KERNEL_GROUPS = (
    ("flash_fwd", "attention forward"),
    ("flash_bwd", "attention backward"),
    ("bwd_phased_bf16", "attention backward"),
    ("bwd_rows_kernel", "attention backward"),
    ("bwd_cols_kernel", "attention backward"),
    ("outproj_", "attention + out-projection"),
    ("mlp_bf16", "fused MLP"),
    ("nvjet", "gemm"), ("gemm", "gemm"), ("cutlass", "gemm"), ("xmma", "gemm"),
    ("gemv", "gemm"), ("splitk", "gemm"),
    ("multi_tensor", "optimizer"),
    ("nccl", "collectives"),
    ("copy", "casts and copies"),
)
ELEMENTWISE = ("elementwise and reductions", "casts and copies")


def kernel_group(name: str) -> str:
    low = name.lower()
    for frag, group in KERNEL_GROUPS:
        if frag in low:
            return group
    return "elementwise and reductions"


def device_events(events: Iterable[dict], window: Tuple[float, float]) -> List[dict]:
    lo, hi = window
    return [e for e in events if e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi]


def busy_intervals(events: Iterable[dict], window: Tuple[float, float]) -> List[list]:
    """The union of the device events' intervals inside the window, merged,
    in order (us)."""
    lo, hi = window
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events if e.get("cat") in DEVICE_CATS)
    merged: List[list] = []
    for s, t in spans:
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def busy_us(events: Iterable[dict], window: Tuple[float, float]) -> float:
    return sum(t - s for s, t in busy_intervals(events, window))


def device_s_by_group(events: Iterable[dict], window: Tuple[float, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for e in device_events(events, window):
        if e["cat"] == "kernel":
            group = kernel_group(e["name"])
        elif e["cat"] == "gpu_memcpy":
            group = "host<->device copies"
        else:
            group = "memsets"
        out[group] = out.get(group, 0.0) + e["dur"] / 1e6
    return out


def top_device_ops(events: Iterable[dict], window: Tuple[float, float],
                   n: int = 10) -> List[list]:
    """The device operations that took most time, by name, in seconds."""
    by_name: Dict[str, float] = {}
    for e in device_events(events, window):
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    return [[name[:160], s] for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def _host_label(runtime: List[dict], device: List[dict], at: float) -> str:
    """What the host was in at time `at`: the CUDA runtime call in progress
    then, or none; and the device operation that ended the wait."""
    call = [e for e in runtime if e["ts"] <= at <= e["ts"] + e["dur"]]
    after = [e for e in device if e["ts"] >= at]
    host = min(call, key=lambda e: e["dur"])["name"] if call else "host between runtime calls"
    nxt = min(after, key=lambda e: e["ts"])["name"][:60] if after else "the span's end"
    return f"{host} > then {nxt}"


def idle_gaps(events: List[dict], window: Tuple[float, float], edges_us: float = 0.0,
              n: int = 10) -> List[list]:
    """The longest stretches between device operations in which the device
    ran nothing, each named by what the host was doing in its middle;
    `edges_us`, the span's time before the first and after the last device
    operation, counts as one stretch."""
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    gaps, at = [], window[0]
    for s, t in busy_intervals(events, window):
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = [[_host_label(runtime, device, (a + b) / 2), (b - a) / 1e6] for a, b in gaps[:n]]
    if edges_us > 0:
        out.append(["before the first and after the last device operation", edges_us / 1e6])
    out.sort(key=lambda g: -g[1])
    return out[:n]


def device_span(events: List[dict]) -> Tuple[float, float]:
    """From the first device operation's start to the last one's end (us)."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    if not spans:
        return (0.0, 0.0)
    return min(s for s, _ in spans), max(t for _, t in spans)


class Reading:
    """What the traced span says, for the per-layer readers: the traced
    units (steps or batches) and samples, the span's length by the host
    clock and the device's busy time in it (s), device time by group (s),
    the counts of the traced units' work (`core.counts`), the card's peaks
    and the chips."""

    def __init__(self, kind: str, events: List[dict], window_s: float, units: int, samples: int,
                 counts: dict, peaks: Optional[dict], chips: int):
        self.kind = kind
        self.events = events
        self.window = device_span(events)
        self.window_s = window_s
        self.busy_s = busy_us(events, self.window) / 1e6
        self.group_s = device_s_by_group(events, self.window)
        self.units = units
        self.samples = samples
        self.counts = counts
        self.peaks = peaks
        self.chips = chips

    def group(self, *names: str) -> float:
        return sum(self.group_s.get(n, 0.0) for n in names)

    def roofline_pct(self, count_key: str, *groups: str) -> Optional[float]:
        """Least time of the counted work over the device time of the
        groups that ran it, in %; None where no kernel of them ran."""
        bound = self.counts[count_key]["bound_s"]
        took = self.group(*groups)
        if bound is None or took <= 0.0 or self.counts[count_key]["calls"] == 0:
            return None
        return 100.0 * bound / took

    def mfu_pct(self) -> Optional[float]:
        if self.peaks is None or self.window_s <= 0.0:
            return None
        peak = self.peaks["flops"]["bf16"] * self.chips
        return 100.0 * self.counts["model"]["flops"] / (self.window_s * peak)

    def breakdown(self) -> dict:
        return {"device_ops": top_device_ops(self.events, self.window),
                "idle_gaps": idle_gaps(self.events, self.window,
                                       self.window_s * 1e6 - (self.window[1] - self.window[0]))}


class TraceSession:
    """Starts the profiler, device activity only, before unit `start`
    (0-based within the window) and stops it after `units` units; the
    loader calls `before(i)` before it hands out unit i.  Each end is a
    synchronise, so every device operation of the traced units lies between
    them, and the host clock between them is the traced span's length
    (`window_s`).  Recording the host's operators as well slowed a flagship
    step's launches by a sixth and made the card idle for it, so the host
    is seen only through the CUDA runtime calls the trace holds."""

    def __init__(self, start: int, units: int, sync):
        self.start, self.units, self.sync = start, units, sync
        self.prof = None
        self.t0 = self.window_s = None
        self.events: Optional[List[dict]] = None
        self.traced: List[int] = []   # window unit indices traced

    def before(self, i: int) -> None:
        import torch

        if i == self.start and self.prof is None and self.events is None:
            self.sync()
            acts = [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else \
                [torch.profiler.ProfilerActivity.CPU]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif i == self.start + self.units and self.prof is not None:
            self.finish()
        if self.prof is not None and i < self.start + self.units:
            self.traced.append(i)

    def finish(self) -> None:
        if self.prof is None:
            return
        self.sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        self.prof = None
