"""The program's spans against a made-up trace: launches put under spans
through the correlation, across two threads; the idle time split by the
loop's spans; the span readings None without spans and where the spans'
count is not the counted calls'; and the span session on the CPU, with the
program's recorder and without one."""

import pytest

from benchmark.core import spans as sp
from benchmark.core import trace


def span(name, ts, dur, sid, parent=None, tid=11, ident=0x7FBF00F7B300, unit=0):
    return {"ph": "X", "cat": "span", "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": {"id": sid, "parent": parent, "unit": unit, "ident": ident}}


def launch(ts, corr, tid):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": tid,
            "ts": ts, "dur": 2, "args": {"correlation": corr}}


def dev(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# the loop's thread: native 11, pthread 0x7fbf00f7b300; autograd's: native
# 12, pthread 0x7f26a0bff6c0.  Without host activity traced, the trace
# names a thread by its pthread id's low 32 bits read as a signed int32 and
# made positive (as an H100's trace did for these two ids).
MAIN, AUTO = 0x00F7B300, 0x5F400940
SPANS = [
    span("train.next_batch", 0, 40, 1),
    span("train.to_device", 40, 60, 2),
    span("train.step", 100, 700, 3),
    span("step.forward", 100, 200, 4, 3),
    span("encode.image", 110, 150, 5, 4),
    span("attn.fwd", 120, 20, 6, 5),
    span("step.backward", 300, 400, 7, 3),
    span("attn.bwd", 350, 100, 8, 7, tid=12, ident=0x7F26A0BFF6C0),
    span("step.optimizer", 700, 100, 9, 3),
    span("train.sync", 800, 200, 10),
]
EVENTS = [
    launch(50, 1, MAIN), dev("Memcpy HtoD (Pinned -> Device)", 90, 10, 1, "gpu_memcpy"),
    launch(115, 2, MAIN), dev("nvjet_gemm", 120, 30, 2),
    launch(125, 3, MAIN), dev("renamed_attention_forward", 150, 20, 3),
    launch(200, 4, MAIN), dev("elementwise", 200, 50, 4),
    launch(320, 5, AUTO), dev("elementwise_bwd", 320, 30, 5),      # no span on its thread
    launch(360, 6, AUTO), dev("fused_attention_bwd", 360, 80, 6),
    launch(710, 7, MAIN), dev("multi_tensor_apply_kernel", 710, 60, 7),
    launch(1000, 8, MAIN), dev("stray", 1000, 5, 8),               # after every span
]


def test_cupti_thread_ids():
    assert sp.cupti_tid(0x7FBF00F7B300) == 0x00F7B300
    assert sp.cupti_tid(0x7F26A0BFF6C0) == 0x5F400940
    assert sp.cupti_tid(0x7F4F8D483300) == 0x72B7CD00


def test_launches_belong_to_the_innermost_span_of_their_thread():
    s = sp.Spans(EVENTS, SPANS)
    owner = {EVENTS[i]["args"]["correlation"]: o["name"] for i, o in s.owner.items()}
    assert owner == {1: "train.to_device", 2: "encode.image", 3: "attn.fwd",
                     4: "encode.image", 5: "step.backward", 6: "attn.bwd",
                     7: "step.optimizer"}
    assert s.loop == 11
    window = (0, 1100)
    assert s.unowned(window) == {"stray": 1}
    assert s.count("attn.fwd") == 1 and s.count("attn.bwd") == 1
    assert s.device_s(window, "attn.fwd") == pytest.approx(20e-6)
    assert s.device_s(window, "attn.bwd") == pytest.approx(80e-6)
    # a span's device time holds its children's
    assert s.device_s(window, "encode.image") == pytest.approx(100e-6)
    assert s.device_s(window, "step.forward") == pytest.approx(100e-6)
    assert s.device_s(window, "step.backward") == pytest.approx(110e-6)
    assert s.device_s(window, "step.optimizer") == pytest.approx(60e-6)
    assert s.device_s(window, "train.next_batch", "train.sync") == 0.0


def test_idle_time_split_by_the_loops_spans():
    s = sp.Spans(EVENTS, SPANS)
    idle = s.idle_s((0, 1100))
    # busy: [90, 100] [120, 170] [200, 250] [320, 350] [360, 440] [710, 770]
    # [1000, 1005]; autograd's attn.bwd is not the loop thread's
    assert idle == pytest.approx({
        "train.next_batch": 40e-6, "train.to_device": 50e-6,
        "step.forward": 10e-6 + 40e-6,                    # [100,110] [260,300]
        "encode.image": 10e-6 + 30e-6 + 10e-6,            # [110,120] [170,200] [250,260]
        "step.backward": 20e-6 + 10e-6 + 260e-6,          # [300,320] [350,360] [440,700]
        "step.optimizer": 10e-6 + 30e-6,                  # [700,710] [770,800]
        "train.sync": 200e-6, None: 95e-6})               # [800,1000]; [1005,1100]
    total = 1100 - sum(t - a for a, t in trace.busy_intervals(EVENTS, (0, 1100)))
    assert sum(idle.values()) == pytest.approx(total / 1e6)


class _Reading:
    kind = "train"

    def __init__(self, spans, calls=1):
        self.events, self.units = EVENTS + spans, 2
        self.window = trace.device_span(EVENTS)
        self.counts = {"attn_fwd": {"bound_s": 10e-6, "calls": calls},
                       "attn_bwd": {"bound_s": 20e-6, "calls": calls}}


def test_readings_from_the_spans():
    r = _Reading(SPANS)
    assert sp.span_roofline_pct(r, "attn_fwd", "attn.fwd") == pytest.approx(50.0)
    assert sp.span_roofline_pct(r, "attn_bwd", "attn.bwd") == pytest.approx(25.0)
    assert sp.device_ms_per_unit(r, "step.optimizer") == pytest.approx(0.03)
    assert sp.device_ms_per_unit(r, "encode.image") == pytest.approx(0.05)
    assert sp.idle_ms_per_unit(r, "train.next_batch", "train.to_device") == pytest.approx(0.045)
    assert sp.readings(r) == pytest.approx({
        "attn_fwd_span_roofline.train": 50.0, "attn_bwd_span_roofline.train": 25.0,
        "optimizer_ms.train": 0.03, "input_stall_ms.train": 0.045})
    # the spans among the events move no reading of the trace
    assert trace.busy_us(r.events, r.window) == trace.busy_us(EVENTS, r.window)
    assert trace.idle_gaps(r.events, r.window) == trace.idle_gaps(EVENTS, r.window)


def test_readings_none_without_spans():
    r = _Reading([])
    assert sp.index(r) is None
    assert sp.readings(r) == {"attn_fwd_span_roofline.train": None,
                              "attn_bwd_span_roofline.train": None,
                              "optimizer_ms.train": None, "input_stall_ms.train": None}
    r.kind = "embed"
    assert set(sp.readings(r)) == {"attn_fwd_span_roofline.embed", "io_stall_ms.embed",
                                   "image_encode_ms.embed", "dna_encode_ms.embed",
                                   "text_encode_ms.embed"}
    assert not any(sp.readings(r).values())


def test_rooflines_none_where_the_span_count_is_not_the_counted_calls():
    r = _Reading(SPANS, calls=2)
    assert sp.span_roofline_pct(r, "attn_fwd", "attn.fwd") is None
    assert sp.span_roofline_pct(r, "attn_bwd", "attn.bwd") is None


def _traced_session(monkeypatch, with_recorder: bool):
    """A span session over two units of the CPU's work, the program's
    spans around each; → its events."""
    import torch

    from clibd_tpu_torch.utils import profiling

    if not with_recorder:
        monkeypatch.delattr(profiling, "SpanRecorder")
    session = sp.SpanSession(0, 2, sync=lambda: None)
    x = torch.randn(64, 64)
    for i in range(3):
        session.before(i)
        with profiling.span("train.step"):
            with profiling.span("step.forward"):
                x = torch.tanh(x @ x)
    assert session.prof is None and session.traced == [0, 1]
    assert profiling._ACTIVE is None
    return session.events


def test_span_session_merges_the_programs_spans(monkeypatch):
    events = _traced_session(monkeypatch, with_recorder=True)
    spans = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in spans] == ["step.forward", "train.step"] * 2
    assert all(e["tid"] == spans[0]["tid"] for e in spans)
    # on the trace's clock: the host operators of a step lie inside its span
    steps = [e for e in spans if e["name"] == "train.step"]
    mm = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
    assert len(mm) == 2
    for op, step in zip(mm, steps):
        assert step["ts"] - 1000 <= op["ts"]
        assert op["ts"] + op["dur"] <= step["ts"] + step["dur"] + 1000


def test_span_session_without_a_recorder_records_no_span(monkeypatch):
    events = _traced_session(monkeypatch, with_recorder=False)
    assert events and not [e for e in events if e.get("cat") == "span"]
