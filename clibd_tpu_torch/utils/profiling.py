"""Timing: the port of `PhaseTimer` and `StepTimer` in
`clibd_tpu/utils/profiling.py`, `cuda_ms`, device time by CUDA events,
`timeit`, the harnesses' best-of-passes host clock, and `card_line`, the
card that a time was taken on.

A phase ends, and a step is ticked, with `torch.cuda.synchronize(device)`
when the timer's device is CUDA, so the time of asynchronous kernels lands in
the phase or step that launched them and not in the next one.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Dict, List, Optional

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
