"""Idle share, device groups, idle gaps and the readers on a made-up trace."""

import pytest

from benchmark.core import trace
from benchmark.core.cell import BENCH, load_json, load_module


def ev(name, cat, ts, dur, tid=1, ph="X"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "ph": ph}


# a traced span of 1000 us by the host clock; the device busy from 100 on
WINDOW_S = 1000e-6
EVENTS = [
    ev("cudaMemcpyAsync", "cuda_runtime", 90, 10),
    ev("cudaStreamSynchronize", "cuda_runtime", 260, 30),
    ev("void flash_fwd_wgmma_kernel<4>(...)", "kernel", 100, 100, tid=7),
    ev("void bwd_rows_kernel<2>(...)", "kernel", 150, 100, tid=7),    # overlaps the first
    ev("nvjet_hsh_256x128_2x1_v_bz_coopA_NNN", "kernel", 300, 200, tid=7),
    ev("void at::native::elementwise_kernel<...>", "kernel", 500, 100, tid=7),
    ev("void at::native::direct_copy_kernel_cuda(...)", "kernel", 600, 50, tid=7),
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 700, 50, tid=7),
]


def test_busy_time_is_the_union_of_device_events():
    window = trace.device_span(EVENTS)
    assert window == (100, 750)
    # busy: [100, 250] + [300, 650] + [700, 750] = 550 us
    assert trace.busy_us(EVENTS, window) == 550


def test_group_sums():
    groups = trace.device_s_by_group(EVENTS, (0, 1000))
    assert groups["attention forward"] == pytest.approx(100e-6)
    assert groups["attention backward"] == pytest.approx(100e-6)
    assert groups["gemm"] == pytest.approx(200e-6)
    assert groups["elementwise and reductions"] == pytest.approx(100e-6)
    assert groups["casts and copies"] == pytest.approx(50e-6)
    assert groups["host<->device copies"] == pytest.approx(50e-6)


def test_idle_gaps_name_what_the_host_did():
    gaps = trace.idle_gaps(EVENTS, (100, 750), edges_us=350)
    assert gaps[0] == ["before the first and after the last device operation",
                       pytest.approx(350e-6)]
    assert gaps[1][1] == pytest.approx(50e-6)
    assert gaps[1][0].startswith("cudaStreamSynchronize > then nvjet")
    assert gaps[2][0].startswith("host between runtime calls > then Memcpy")


def test_readers_on_a_reading():
    counts = {"model": {"flops": 989e12 * 0.5e-3},
              "gemm": {"bound_s": 100e-6, "calls": 1},
              "attn_fwd": {"bound_s": 50e-6, "calls": 1},
              "attn_bwd": {"bound_s": 25e-6, "calls": 1}}
    peaks = {"flops": {"bf16": 989e12}, "hbm_bytes_per_s": 3.35e12}
    r = trace.Reading("train", EVENTS, WINDOW_S, units=2, samples=10, counts=counts,
                      peaks=peaks, chips=1)
    spec = load_json(BENCH.parent / "BENCHMARK.json")
    got = {}
    for m in spec["per_layer"]:
        if m["name"].endswith(".train"):
            got[m["name"]] = load_module(BENCH / "metrics" / f"{m['name']}.py").read(r)
    assert got["device_idle_pct.train"] == pytest.approx(45.0)
    assert got["mfu.train"] == pytest.approx(50.0)
    assert got["gemm_roofline.train"] == pytest.approx(50.0)
    assert got["attn_fwd_roofline.train"] == pytest.approx(50.0)
    assert got["attn_bwd_roofline.train"] == pytest.approx(25.0)
    assert got["elementwise_ms.train"] == pytest.approx(150e-3 / 2)
    # an embedding reader finds nothing in a train reading
    assert load_module(BENCH / "metrics" / "mfu.embed.py").read(r) is None


def test_a_renamed_kernel_reads_nothing():
    events = [e for e in EVENTS if "flash_fwd" not in e["name"]]
    counts = {"attn_fwd": {"bound_s": 50e-6, "calls": 1}}
    r = trace.Reading("train", events, WINDOW_S, 1, 1, counts, None, 1)
    assert r.roofline_pct("attn_fwd", "attention forward") is None


def test_breakdown_has_at_most_ten_of_each():
    r = trace.Reading("train", EVENTS, WINDOW_S, 1, 1, {"model": {"flops": 1.0}}, None, 1)
    b = r.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"][0][0].startswith("nvjet") and len(b["device_ops"]) <= 10
