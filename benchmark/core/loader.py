"""The loader the program consumes: a fixed pool of host batches made in
set-up, handed out in the `BioscanLoader` interface that `Trainer` and
`extract_split` read (`batches()`, `len()`, `label_dicts()`, `ids()`,
`close()`, `spec.batch_size`).

Two modes:
- `plan(count)`: the next `batches()` call yields `count` batches, from
  `start_batch` on (the set-up's steps, each a different pool batch);
  `sequence` records the pool batch of every one handed out;
- `window(t0, seconds)`: `batches()` cycles the pool and stops at the first
  request made `seconds` or more after `t0`, so the window holds whole
  steps or batches; `asked` records when each request came.

In a traced run the loader tells the trace session which unit of the
window it is about to hand out (`TraceSession.before`).
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, List, Optional


class PoolLoader:
    def __init__(self, pool: List[dict], epoch_batches: int, batch_size: int,
                 clock: Callable[[], float] = time.perf_counter,
                 agree: Optional[Callable[[bool], bool]] = None):
        """agree(stop) → whether every rank stops, where ranks must end the
        window at the same step; None for one process."""
        self.pool = pool
        self.spec = SimpleNamespace(batch_size=batch_size)
        self.epoch_batches = epoch_batches
        self.clock = clock
        self.agree = agree
        self.count: Optional[int] = None
        self.t0 = self.seconds = None
        self.session = None
        self.sequence: List[int] = []
        levels = ("order", "family", "genus", "species")
        self._labels = [[{lv: f"{lv}_{(p * batch_size + r) % (3 + 4 * i)}"
                          for i, lv in enumerate(levels)} for r in range(batch_size)]
                        for p in range(len(pool))]

    def plan(self, count: int) -> None:
        self.count, self.t0, self.session = count, None, None
        self.sequence = []

    def window(self, t0: float, seconds: float, session=None) -> None:
        self.count, self.t0, self.seconds, self.session = None, t0, seconds, session
        self.sequence, self.asked = [], []

    def batches(self, epoch: int = 0, shuffle: bool = False, start_batch: int = 0):
        i = 0
        while True:
            if self.t0 is None:
                if i >= self.count:
                    return
                p = (start_batch + i) % len(self.pool)
            else:
                now = self.clock() - self.t0
                self.asked.append(now)
                stop = now >= self.seconds
                if self.agree is not None:
                    stop = self.agree(stop)
                if stop:
                    return
                if self.session is not None:
                    self.session.before(i)
                p = i % len(self.pool)
            self.sequence.append(p)
            yield self.pool[p]
            i += 1

    def __len__(self) -> int:
        return self.epoch_batches

    def label_dicts(self) -> list:
        return [d for p in self.sequence for d in self._labels[p]]

    def ids(self) -> list:
        return [f"row_{i}" for i in range(len(self.sequence) * self.spec.batch_size)]

    def close(self) -> None:
        pass
