"""The last line's keys, and the checks beside their limits."""

import json

from benchmark.core.compare import NOT_COMPARED, judge
from benchmark.core.trace import Reading
from benchmark.run import result_line
from benchmark.tests.sizes import tiny_cell
from benchmark.tests.test_benchmark_trace import EVENTS, WINDOW_S


def fake_result(numbers, limits, reading=None):
    return {"e2e": {"train_samples_per_s": 812.5, "peak_mem_gib": 11.3, "setup_s": 31.0},
            "attempted": 17, "failed": 0, "memory_peak_bytes": 12133023744,
            "reading": reading, "checks": judge(numbers, limits)}


DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_trace_0_line():
    cell = tiny_cell("flagship-train")
    line = result_line(cell, fake_result({"loss_gap": 1e-4}, {"loss_gap": 1e-3}), False, DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 31.0, "unit": "s"}
    assert line["device"]["memory_peak_bytes"] == 12133023744
    assert line["checks"]["loss_gap"] == {"value": 1e-4, "limit": 1e-3, "ok": True}
    json.dumps(line)


def test_trace_1_line_has_device_time_and_breakdown_before_checks():
    cell = tiny_cell("flagship-train")
    counts = {"model": {"flops": 1e12}, "gemm": {"bound_s": 1e-4, "calls": 1},
              "attn_fwd": {"bound_s": 5e-5, "calls": 1}, "attn_bwd": {"bound_s": 1e-5, "calls": 1}}
    reading = Reading("train", EVENTS, WINDOW_S, 1, 500, counts,
                      {"flops": {"bf16": 989e12}, "hbm_bytes_per_s": 3.35e12}, 1)
    line = result_line(cell, fake_result({"loss_gap": 1.0}, {"loss_gap": 1e-3}, reading), True,
                       DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is False
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert "device_idle_pct.train" in line["metrics"]
    assert all(not k.endswith(".embed") for k in line["metrics"])


def test_a_number_without_a_limit_fails_and_not_compared_passes():
    got = judge({"a": 0.1, "b": 0.1, "c": float("nan")}, {"b": NOT_COMPARED, "c": 1.0})
    assert not got["a"]["ok"] and got["b"]["ok"] and not got["c"]["ok"]
