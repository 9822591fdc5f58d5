"""The window's arithmetic: whole steps, every sample over all the time."""

import numpy as np

from benchmark.core.loader import PoolLoader


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def pool(n=3, rows=2):
    return [{"label": np.arange(i * rows, (i + 1) * rows)} for i in range(n)]


def test_plan_hands_out_count_batches_from_start():
    loader = PoolLoader(pool(), 100, 2)
    loader.plan(2)
    got = [b["label"][0] for b in loader.batches(start_batch=1)]
    assert got == [2, 4] and loader.sequence == [1, 2] and len(loader) == 100


def test_window_ends_at_the_first_request_past_its_length():
    """Steps of 0.4 s in a 1 s window: the third starts at 0.8 s, so three
    steps run, and the window is the 1.2 s they took."""
    clock = Clock()
    loader = PoolLoader(pool(), 100, 2, clock=clock)
    loader.window(0.0, 1.0)
    steps = 0
    for _ in loader.batches():
        clock.t += 0.4
        steps += 1
    assert steps == 3 and loader.sequence == [0, 1, 2]
    rate = steps * 2 / clock.t
    assert abs(rate - 5.0) < 1e-9


def test_window_cycles_the_pool_and_labels_every_row():
    clock = Clock()
    loader = PoolLoader(pool(n=2), 100, 2, clock=clock)
    loader.window(0.0, 1.0)
    for _ in loader.batches():
        clock.t += 0.2
    assert loader.sequence == [0, 1, 0, 1, 0]
    assert len(loader.label_dicts()) == len(loader.ids()) == 10
    assert len(set(loader.ids())) == 10


def test_trace_session_is_told_each_unit():
    seen = []

    class Session:
        def before(self, i):
            seen.append(i)

    clock = Clock()
    loader = PoolLoader(pool(), 100, 2, clock=clock)
    loader.window(0.0, 1.0, Session())
    for _ in loader.batches():
        clock.t += 0.3
    assert seen == [0, 1, 2, 3]
