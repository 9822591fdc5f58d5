"""The program's spans (`clibd_tpu_torch.utils.profiling`): the shared no-op
while nothing records, nesting, parents, units and threads, the chrome-trace
events and their clock against `torch.profiler`'s, and the span tree of a
tiny train step and of an extraction batch."""

import json
import os
import tempfile
import threading
import time
from collections import Counter

import pytest
import torch

from clibd_tpu_torch.utils import profiling
from clibd_tpu_torch.utils.profiling import SpanRecorder, loop_units, span
from tests.torch_tiny import port_tiny_cfg


@pytest.fixture
def recorder():
    rec = SpanRecorder().start()
    try:
        yield rec
    finally:
        rec.stop()


def test_off_span_is_the_shared_no_op():
    assert profiling._ACTIVE is None
    first, second = span("a"), span("b")
    assert first is second is profiling._NO_SPAN
    with span("a") as s:
        assert s is None
    assert list(loop_units([1, 2], "loop.next")) == [1, 2]
    rec = SpanRecorder()
    assert rec.spans == [] and rec.to_trace_events() == []


def test_nesting_parents_units_and_threads(recorder):
    seen = {}

    def worker():
        seen["tid"], seen["ident"] = threading.get_native_id(), threading.get_ident()
        with span("t.outer"):
            with span("t.inner"):
                pass

    for item in loop_units(["x", "y"], "loop.next", first=5):
        with span("loop.body"):
            with span("body.inner"):
                if item == "y":
                    t = threading.Thread(target=worker)
                    t.start()
                    t.join(timeout=30)
                    assert not t.is_alive()
    spans = recorder.stop()
    assert not recorder.on and profiling._ACTIVE is None
    by_id = {s.id: s for s in spans}
    names = Counter(s.name for s in spans)
    # two items fetched, and the fetch that found the end
    assert names == {"loop.next": 3, "loop.body": 2, "body.inner": 2, "t.outer": 1,
                     "t.inner": 1}
    assert len(by_id) == len(spans)
    main = threading.get_native_id()
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.name.startswith("t."):
            assert (s.tid, s.ident) == (seen["tid"], seen["ident"])
            assert s.unit == 6
        else:
            assert (s.tid, s.ident) == (main, threading.get_ident())
        if s.name in ("loop.next", "loop.body"):
            assert s.parent is None
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert [s.unit for s in spans if s.name == "loop.body"] == [5, 6]
    assert [s.unit for s in spans if s.name == "loop.next"] == [5, 6, 7]
    inner = {s.unit: s for s in spans if s.name == "body.inner"}
    assert all(by_id[s.parent].name == "loop.body" and by_id[s.parent].unit == u
               for u, s in inner.items())
    # a thread with no span open: its outermost span's parent is the span
    # open on the recorder's thread
    t_outer = next(s for s in spans if s.name == "t.outer")
    t_inner = next(s for s in spans if s.name == "t.inner")
    assert t_outer.parent == inner[6].id
    assert t_inner.parent == t_outer.id
    # nothing is recorded once stopped
    with span("late"):
        pass
    assert all(s.name != "late" for s in recorder.spans)


def test_one_recorder_at_a_time(recorder):
    with pytest.raises(RuntimeError, match="another SpanRecorder"):
        SpanRecorder().start()


def test_trace_events_are_a_chrome_trace(recorder):
    with span("a"):
        with span("b"):
            time.sleep(0.001)
    recorder.stop()
    base = min(s.start_ns for s in recorder.spans) - 5000
    events = recorder.to_trace_events(base)
    json.loads(json.dumps({"traceEvents": events}))
    assert [e["name"] for e in events] == ["b", "a"]
    for e, s in zip(events, recorder.spans):
        assert e["ph"] == "X" and e["cat"] == "span" and e["pid"] == os.getpid()
        assert e["tid"] == s.tid == threading.get_native_id()
        assert e["ts"] == pytest.approx((s.start_ns - base) / 1e3)
        assert e["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3) and e["dur"] >= 1000
        assert e["args"] == {"id": s.id, "parent": s.parent, "unit": None, "ident": s.ident}
    a, b = events[1], events[0]
    assert b["args"]["parent"] == a["args"]["id"]
    assert a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"]


def test_spans_lie_on_the_profilers_clock():
    """A `record_function` range opened right inside a span: its ends, on
    the chrome trace's clock (`ts` in us from `baseTimeNanoseconds`), within
    1 ms of the span's ends on `time.time_ns()`."""
    x = torch.randn(256, 256)
    rec = SpanRecorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rec.start()
        try:
            with span("outer"):
                with torch.profiler.record_function("inner"):
                    for _ in range(20):
                        x = torch.tanh(x @ x)
        finally:
            rec.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    inner = next(e for e in trace["traceEvents"] if e.get("name") == "inner"
                 and e.get("cat") == "user_annotation")
    (outer,) = rec.to_trace_events(base)
    assert abs(inner["ts"] - outer["ts"]) < 1000.0
    assert abs(inner["ts"] + inner["dur"] - outer["ts"] - outer["dur"]) < 1000.0
    assert inner["dur"] > 0


def _tree(spans):
    by_id = {s.id: s for s in spans}
    return by_id, lambda s: by_id[s.parent].name if s.parent is not None else None


@pytest.mark.parametrize("remat", ["attn", False])
def test_train_step_span_tree(tmp_path, remat):
    """Two steps of `Trainer.train_epoch` at test widths: the loop's spans
    per step, the step's four phases under `train.step`, a tower's span
    under `step.forward` with an `attn.fwd` a layer under it, an `attn.bwd`
    a layer under `step.backward`."""
    from clibd_tpu_torch.config import schema as port_schema
    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine import train as port_train

    gcfg = port_schema.GlobalConfig()
    gcfg.model_config = cfg = port_tiny_cfg(batch_size=4, epochs=1, disable_lora=True,
                                            remat=bool(remat), remat_policy=remat or "none")
    trainer = port_train.Trainer(gcfg, None, str(tmp_path / "out"),
                                 train_loader=SyntheticSplit("train", 8, cfg, seed=0),
                                 device="cpu")
    rec = SpanRecorder().start()
    try:
        trainer.train_epoch(0)
    finally:
        spans = rec.stop()
        trainer.close()
    by_id, parent = _tree(spans)
    layers = {"image": cfg.image.vit.num_layers, "dna": cfg.dna.bert.num_layers,
              "language": cfg.language.bert.num_layers}
    for unit in (0, 1):
        mine = [s for s in spans if s.unit == unit]
        names = Counter(s.name for s in mine)
        for name in ("train.next_batch", "train.to_device", "train.step", "train.sync",
                     "step.forward", "step.loss", "step.backward", "step.optimizer",
                     "encode.image", "encode.dna", "encode.language"):
            assert names[name] == 1, (name, names)
        assert names["train.fetch_loss"] == unit        # step 0's loss, fetched in step 1
        assert names["attn.fwd"] == sum(layers.values())
        assert names["attn.bwd"] == sum(layers.values())
        for s in mine:
            if s.name.startswith("train."):
                assert parent(s) is None
            elif s.name.startswith("step."):
                assert parent(s) == "train.step"
            elif s.name.startswith("encode."):
                assert parent(s) == "step.forward"
            elif s.name == "attn.bwd":
                assert parent(s) == "step.backward"
        for tower, n in layers.items():
            tower_span = next(s for s in mine if s.name == f"encode.{tower}")
            assert sum(1 for s in mine if s.name == "attn.fwd"
                       and s.parent == tower_span.id) == n
    # the fetch that found the end
    assert [s.name for s in spans if s.unit == 2] == ["train.next_batch"]


def test_extract_split_span_tree():
    """One batch of `extract_split` at test widths: the loop's spans, the
    towers under `extract.encode`, an `attn.fwd` a layer under each."""
    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.extract import extract_split
    from clibd_tpu_torch.models import init_clibd_model

    cfg = port_tiny_cfg(batch_size=4)
    model = init_clibd_model(cfg, torch.Generator().manual_seed(0), "cpu")
    rec = SpanRecorder().start()
    try:
        out = extract_split(model, cfg, SyntheticSplit("keys", 4, cfg, seed=1))
    finally:
        spans = rec.stop()
    assert out["encoded_image_feature"].shape == (4, cfg.output_dim)
    by_id, parent = _tree(spans)
    names = Counter(s.name for s in spans)
    assert names == {"extract.next_batch": 2, "extract.to_device": 1, "extract.encode": 1,
                     "extract.to_host": 1, "extract.drain": 1, "encode.image": 1,
                     "encode.dna": 1, "encode.language": 1,
                     "attn.fwd": cfg.image.vit.num_layers + cfg.dna.bert.num_layers
                     + cfg.language.bert.num_layers}
    for s in spans:
        if s.name.startswith("extract."):
            assert parent(s) is None
        elif s.name.startswith("encode."):
            assert parent(s) == "extract.encode"
        else:
            assert parent(s).startswith("encode.")
    # the fetch that found the end, and the last batch's drain after it,
    # under the next unit
    assert [(s.name, s.unit) for s in spans if s.name.startswith("extract.")] == [
        ("extract.next_batch", 0), ("extract.to_device", 0), ("extract.encode", 0),
        ("extract.to_host", 0), ("extract.next_batch", 1), ("extract.drain", 1)]
