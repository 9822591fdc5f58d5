"""Timing: the port of `PhaseTimer` and `StepTimer` in
`clibd_tpu/utils/profiling.py`, `cuda_ms`, device time by CUDA events,
`timeit`, the harnesses' best-of-passes host clock, `card_line`, the card
that a time was taken on, and the program's spans.

A phase ends, and a step is ticked, with `torch.cuda.synchronize(device)`
when the timer's device is CUDA, so the time of asynchronous kernels lands in
the phase or step that launched them and not in the next one.

Spans name the program's own phases on the clock of `torch.profiler`'s
trace.  `span(name)` is a context manager placed where the work happens (the
train and extraction loops, the train step's phases, the towers, the
attention operators); `loop_units` wraps a loop's loader.  They record
nothing until a `SpanRecorder` is started, and then they only read the host
clock: no synchronise, no device work.  A span holds its name, an id, its
parent's id (the innermost span open on its thread; on a thread with none
open, such as autograd's device thread, the innermost open on the thread
that started the recorder), the unit (the step or batch index the loop set),
the thread (`threading.get_native_id()` and `threading.get_ident()`, the
pthread id that CUPTI's runtime records carry) and its start and end in
`time.time_ns()`: the trace's clock, an event's `ts` times 1000 plus the
trace's `baseTimeNanoseconds`.  Spans stay in memory until the recorder
stops; `to_trace_events` gives them as chrome-trace events beside the
profiler's (`benchmark/core/spans.py` puts each device operation of a
trace under the span that launched it).
"""

from __future__ import annotations

import itertools
import os
import statistics
import subprocess
import threading
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional

import torch


# cycles of the spin kernel queued ahead of each timed run (~0.1 ms on an
# H100), longer than the host takes to enqueue a wrapper's launch
_SPIN_CYCLES = 200_000


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device time in ms of fn() on the current CUDA stream, over
    `iters` runs after `warmup` runs, each between two CUDA events.  A spin
    kernel queued ahead of each start event keeps the card busy while the
    host enqueues fn's work, so a run's time is the device's, not the host's
    launch latency (which would otherwise dominate a call of tens of us)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def timeit(fn, device: torch.device | str, warmup: int, iters: int, passes: int) -> float:
    """Seconds a call of fn(): the best of `passes` passes of `iters` calls
    after `warmup` calls, on the host clock, each pass closed by a sync of
    `device` when it is a card."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best / iters


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (first card)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def require_card(tool: str, device: torch.device | str = "cuda") -> Optional[str]:
    """A harness's start: where `device` is a card, raise unless one is
    present, else print and return its `card_line`; None for the CPU."""
    if torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} needs a CUDA card")
    line = card_line()
    print(f"card: {line}", flush=True)
    return line


class StepTimer:
    """Steady-state step time and samples/s, the first `warmup_steps` steps
    excluded (`profiling.py:29-57`).  Each tick waits for the card."""

    def __init__(self, warmup_steps: int = 2, device: torch.device | str = "cuda"):
        self.warmup_steps = warmup_steps
        self.device = torch.device(device)
        self.times: List[float] = []
        self._last: Optional[float] = None
        self._step = 0

    def tick(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self._step += 1
        if self._last is not None and self._step > self.warmup_steps:
            self.times.append(now - self._last)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def samples_per_sec(self, batch_size: int, n_chips: int = 1) -> float:
        st = self.mean_step_time
        return batch_size / st / n_chips if st > 0 else 0.0

    def summary(self, batch_size: int, n_chips: int = 1) -> Dict[str, float]:
        return {
            "mean_step_time_s": self.mean_step_time,
            "samples_per_sec_per_chip": self.samples_per_sec(batch_size, n_chips),
            "steps_timed": len(self.times),
        }


class PhaseTimer:
    """Named wall-time phases for a multi-stage pipeline (`clibd eval`:
    extract → write cache → kNN grid → plots → report); `report()` prints one
    line per phase plus the total."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.phases: List[tuple] = []

    def phase(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                if timer.device.type == "cuda":
                    torch.cuda.synchronize(timer.device)
                timer.phases.append((name, time.perf_counter() - self.t0))
                return False

        return _Ctx()

    def report(self, prefix: str = "eval timing") -> str:
        total = sum(dt for _, dt in self.phases)
        lines = [f"{prefix}: total {total:.2f}s"]
        for name, dt in self.phases:
            pct = 100.0 * dt / total if total else 0.0
            lines.append(f"  {name:28s} {dt:8.2f}s  {pct:5.1f}%")
        return "\n".join(lines)


# -- spans ---------------------------------------------------------------


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    unit: Optional[int]
    tid: int        # threading.get_native_id()
    ident: int      # threading.get_ident(): the pthread id
    start_ns: int   # time.time_ns()
    end_ns: int


class _NoSpan:
    """What `span` returns while nothing records: enters and exits, reads
    no clock."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()
_END = object()
# the recorder that `span` records into; None while nothing records
_ACTIVE: Optional["SpanRecorder"] = None


class _OpenSpan:
    __slots__ = ("rec", "name", "thread", "id", "parent", "unit", "start")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.thread = thread = rec._thread()
        stack = thread[0]
        self.parent = stack[-1] if stack else rec._home_top()
        self.id = next(rec._ids)
        self.unit = rec.unit
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        stack, tid, ident = self.thread
        stack.pop()
        if self.rec.on:
            self.rec.spans.append(Span(self.id, self.parent, self.name, self.unit, tid, ident,
                                       self.start, end))
        return None


def span(name: str):
    """A context manager that records the span `name` into the recorder
    that is on; the shared no-op where none is."""
    rec = _ACTIVE
    if rec is None:
        return _NO_SPAN
    return _OpenSpan(rec, name)


def loop_units(items: Iterable, name: str, first: int = 0) -> Iterator:
    """A loop's loader: yields `items` one by one, each fetched inside
    span(name), with the recorder's unit set to the item's index (from
    `first`) before it is fetched."""
    it = iter(items)
    unit = first
    while True:
        rec = _ACTIVE
        if rec is not None:
            rec.unit = unit
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item
        unit += 1


class SpanRecorder:
    """Records every span opened between `start()` and `stop()`, in any
    thread; one recorder records at a time."""

    def __init__(self):
        self.spans: List[Span] = []
        self.unit: Optional[int] = None
        self.on = False

    def start(self) -> "SpanRecorder":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("another SpanRecorder is recording")
        self.spans, self.unit, self.on = [], None, True
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._home = self._thread()[0]
        _ACTIVE = self
        return self

    def stop(self) -> List[Span]:
        """Stop recording; → the spans that closed while it recorded."""
        global _ACTIVE
        self.on = False
        if _ACTIVE is self:
            _ACTIVE = None
        return self.spans

    def _thread(self) -> tuple:
        """(open span ids, native id, pthread id) of the calling thread."""
        local = self._local
        try:
            return local.thread
        except AttributeError:
            local.thread = ([], threading.get_native_id(), threading.get_ident())
            return local.thread

    def _home_top(self) -> Optional[int]:
        try:
            return self._home[-1]
        except IndexError:
            return None

    def to_trace_events(self, base_ns: int = 0) -> List[dict]:
        """The spans as chrome-trace complete events (`cat` "span"), `ts` and
        `dur` in us from `base_ns`: give the trace's `baseTimeNanoseconds`
        and they lie on its clock."""
        pid = os.getpid()
        return [{"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
                 "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                 "args": {"id": s.id, "parent": s.parent, "unit": s.unit, "ident": s.ident}}
                for s in self.spans]

