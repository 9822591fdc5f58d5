"""The program's spans read against the device trace: which span launched
each kernel, copy and memset, and which span the loop's thread was in while
the card idled.

A span is a chrome-trace complete event of `cat` "span" on the trace's
clock, as the program's recorder gives them (its `to_trace_events` with the
trace's `baseTimeNanoseconds`): `name`, `tid` (the thread's native id),
`ts`, `dur` and `args` {`id`, `parent`, `unit`, `ident` (the thread's
pthread id)}.  Nothing here imports the program: the spans are data.

- A device operation belongs to the innermost span open on the thread of
  its launch, the `cuda_runtime` or `cuda_driver` event with the same
  `args.correlation`, at the launch's start.  A trace names a thread by its
  native id where it traced host activity, else by `cupti_tid` of its
  pthread id (CUPTI's records).  Where the launching thread had no span
  open (autograd's device thread runs the backward's kernels), the
  operation belongs to the innermost span then open on the loop's thread,
  the thread of the outermost spans.
- Idle time, the stretches of the window in which no device operation ran,
  is split by the innermost span of the loop's thread covering each part.

A `SpanSession` is a `TraceSession` that also starts the program's span
recorder right after its opening synchronise and stops it right after its
closing one, and merges the spans into `events`, where no other reading
looks (they are neither device nor runtime events).  On a tree whose
program has no recorder it records no span.  The span readings (`READINGS`)
read the spans from a `Reading`'s events and are None without them, and
the rooflines also where the spans' count of a counted call differs from
`core/counts.py`'s.  `benchmark/span_run.py` runs a cell with it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from benchmark.core.trace import DEVICE_CATS, TraceSession, busy_intervals

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def cupti_tid(ident: int) -> int:
    """The `tid` of a thread's runtime records in a trace of CUDA activity
    alone: the pthread id's low 32 bits as a signed int32, made positive
    (read on an H100 with torch 2.11: 0x7f26a0bff6c0 is 0x5f400940)."""
    low = ident & 0xFFFFFFFF
    return 2 ** 32 - low if low >= 2 ** 31 else low


def _segments(spans: List[dict]) -> Tuple[List[float], List[tuple]]:
    """One thread's nested spans → the time cut into stretches (start, end,
    innermost span covering it), in order, and their starts."""
    segs: List[tuple] = []
    stack: List[dict] = []
    at = 0.0
    for s in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= s["ts"]:
            top = stack.pop()
            segs.append((at, top["ts"] + top["dur"], top))
            at = top["ts"] + top["dur"]
        if stack:
            segs.append((at, s["ts"], stack[-1]))
        stack.append(s)
        at = s["ts"]
    while stack:
        top = stack.pop()
        segs.append((at, top["ts"] + top["dur"], top))
        at = top["ts"] + top["dur"]
    segs = [g for g in segs if g[1] > g[0]]
    return [g[0] for g in segs], segs


def _at(segments, ts: float) -> Optional[dict]:
    starts, segs = segments
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and ts < segs[i][1]:
        return segs[i][2]
    return None


class Spans:
    """The spans of a traced window, indexed against its events."""

    def __init__(self, events: List[dict], spans: List[dict]):
        self.events, self.spans = events, spans
        self.by_id = {s["args"]["id"]: s for s in spans}
        thread: Dict[int, int] = {}
        for s in spans:
            thread[s["tid"]] = s["tid"]
            thread[cupti_tid(s["args"]["ident"])] = s["tid"]
        roots = [s for s in spans if s["args"]["parent"] is None]
        self.loop = min(roots, key=lambda s: s["ts"])["tid"] if roots else None
        tids = set(thread.values())
        self.segments = {t: _segments([s for s in spans if s["tid"] == t]) for t in tids}
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        # device operation (its index in events) -> the span that launched it
        self.owner: Dict[int, dict] = {}
        for i, e in enumerate(events):
            if e.get("cat") not in DEVICE_CATS:
                continue
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            tid = thread.get(launch["tid"])
            owner = _at(self.segments[tid], launch["ts"]) if tid is not None else None
            if owner is None and self.loop is not None:
                owner = _at(self.segments[self.loop], launch["ts"])
            if owner is not None:
                self.owner[i] = owner

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s["name"] == name)

    def extent(self) -> Tuple[float, float]:
        return (min(s["ts"] for s in self.spans),
                max(s["ts"] + s["dur"] for s in self.spans))

    def inside(self, span: dict, names: Tuple[str, ...]) -> bool:
        """Whether `span` or a span around it is named one of `names`."""
        while span is not None:
            if span["name"] in names:
                return True
            span = self.by_id.get(span["args"]["parent"])
        return False

    def device_s(self, window: Tuple[float, float], *names: str) -> float:
        """Seconds of the device operations starting inside `window` that a
        span named one of `names`, or a span inside one, launched."""
        lo, hi = window
        return sum(self.events[i]["dur"] for i, s in self.owner.items()
                   if lo <= self.events[i]["ts"] <= hi and self.inside(s, names)) / 1e6

    def unowned(self, window: Tuple[float, float]) -> Dict[str, int]:
        """The device operations inside `window` that no span launched:
        name → count."""
        lo, hi = window
        out: Dict[str, int] = {}
        for i, e in enumerate(self.events):
            if e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi and i not in self.owner:
                out[e["name"]] = out.get(e["name"], 0) + 1
        return out

    def idle_s(self, window: Tuple[float, float]) -> Dict[Optional[str], float]:
        """The window's idle seconds by the innermost span of the loop's
        thread covering them (None: no span)."""
        gaps, at = [], window[0]
        for s, t in busy_intervals(self.events, window):
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if window[1] > at:
            gaps.append((at, window[1]))
        out: Dict[Optional[str], float] = {}
        segments = self.segments.get(self.loop, ([], []))
        for a, b in gaps:
            i = max(bisect.bisect_right(segments[0], a) - 1, 0)
            covered = 0.0
            for lo, hi, s in segments[1][i:]:
                if lo >= b:
                    break
                part = min(hi, b) - max(lo, a)
                if part > 0:
                    out[s["name"]] = out.get(s["name"], 0.0) + part / 1e6
                    covered += part
            if b - a > covered:
                out[None] = out.get(None, 0.0) + (b - a - covered) / 1e6
        return out


def index(reading) -> Optional[Spans]:
    """The reading's spans indexed (once), None where it has none."""
    found = getattr(reading, "_span_index", None)
    if found is None:
        spans = [e for e in reading.events if e.get("cat") == "span"]
        if not spans:
            return None
        found = reading._span_index = Spans(reading.events, spans)
    return found


def window(reading, spans: Spans) -> Tuple[float, float]:
    """The traced window on the trace's clock: the device's first to last
    operation, widened to the spans' extent."""
    lo, hi = spans.extent()
    return min(reading.window[0], lo), max(reading.window[1], hi)


def span_roofline_pct(reading, count_key: str, name: str) -> Optional[float]:
    """Least time of the counted calls over the device time the spans
    `name` launched, in %; None without spans, where their number is not
    the counted calls', or where they launched nothing."""
    spans = index(reading)
    if spans is None:
        return None
    counted = reading.counts[count_key]
    if counted["bound_s"] is None or counted["calls"] == 0 or spans.count(name) != counted["calls"]:
        return None
    took = spans.device_s(window(reading, spans), name)
    return 100.0 * counted["bound_s"] / took if took > 0.0 else None


def device_ms_per_unit(reading, *names: str) -> Optional[float]:
    """Device ms a traced unit of the operations launched inside the spans
    `names`; None without spans."""
    spans = index(reading)
    if spans is None or reading.units == 0:
        return None
    return 1e3 * spans.device_s(window(reading, spans), *names) / reading.units


def idle_ms_per_unit(reading, *names: str) -> Optional[float]:
    """Device-idle ms a traced unit while the loop's innermost span was one
    of `names`; None without spans."""
    spans = index(reading)
    if spans is None or reading.units == 0:
        return None
    idle = spans.idle_s(window(reading, spans))
    return 1e3 * sum(idle.get(n, 0.0) for n in names) / reading.units


# name -> (reading kind, how it is read), the per-layer metrics the spans give
READINGS = {
    "attn_fwd_span_roofline.train": ("train", lambda r: span_roofline_pct(r, "attn_fwd",
                                                                          "attn.fwd")),
    "attn_bwd_span_roofline.train": ("train", lambda r: span_roofline_pct(r, "attn_bwd",
                                                                          "attn.bwd")),
    "optimizer_ms.train": ("train", lambda r: device_ms_per_unit(r, "step.optimizer")),
    "input_stall_ms.train": ("train", lambda r: idle_ms_per_unit(r, "train.next_batch",
                                                                 "train.to_device")),
    "attn_fwd_span_roofline.embed": ("embed", lambda r: span_roofline_pct(r, "attn_fwd",
                                                                          "attn.fwd")),
    "io_stall_ms.embed": ("embed", lambda r: idle_ms_per_unit(
        r, "extract.next_batch", "extract.to_device", "extract.to_host", "extract.drain")),
    "image_encode_ms.embed": ("embed", lambda r: device_ms_per_unit(r, "encode.image")),
    "dna_encode_ms.embed": ("embed", lambda r: device_ms_per_unit(r, "encode.dna")),
    "text_encode_ms.embed": ("embed", lambda r: device_ms_per_unit(r, "encode.language")),
}


def readings(reading) -> Dict[str, Optional[float]]:
    """Every span reading of the reading's kind."""
    return {name: read(reading) for name, (kind, read) in READINGS.items()
            if kind == reading.kind}


class SpanSession(TraceSession):
    """A `TraceSession` that records the program's spans between its two
    synchronises and merges them into `events` on the trace's clock."""

    rec = None

    def before(self, i: int) -> None:
        opening = i == self.start and self.prof is None and self.events is None
        super().before(i)
        if opening:
            from clibd_tpu_torch.utils import profiling

            recorder = getattr(profiling, "SpanRecorder", None)
            self.rec = recorder().start() if recorder is not None else None

    def finish(self) -> None:
        """`TraceSession.finish`, the recorder stopped right after the
        synchronise and its spans merged in with the trace's base time."""
        if self.prof is None:
            return
        self.sync()
        self.window_s = time.perf_counter() - self.t0
        if self.rec is not None:
            self.rec.stop()
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        self.events = trace["traceEvents"]
        if self.rec is not None:
            self.events += self.rec.to_trace_events(trace.get("baseTimeNanoseconds", 0))
        self.prof = None
