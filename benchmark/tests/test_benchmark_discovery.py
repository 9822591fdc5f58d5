"""Configurations, traffic mixes, checks and metrics are found by name from
files alone, and a new cell or metric needs new files and entries only."""

import json
import shutil

from benchmark.core.cell import BENCH, Cell, load_json


def test_every_cell_finds_its_files():
    spec = load_json(BENCH.parent / "BENCHMARK.json")
    for w in spec["workloads"]:
        cell = Cell(w["name"], spec)
        assert cell.config["name"] == w["config"]
        assert callable(cell.driver.run)
        assert cell.per_layer and all(callable(r.read) for r in cell.readers.values())
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
    for c in spec["configs"]:
        assert (BENCH.parent / c["file"]).is_file()


def test_a_new_cell_and_metric_are_new_files_and_entries(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = load_json(BENCH.parent / "BENCHMARK.json")
    traffic = load_json(BENCH / "traffic" / "train.json")
    traffic.update(batch_size=250, about="half batches")
    (bench / "traffic" / "train_half.json").write_text(json.dumps(traffic))
    (bench / "checks" / "flagship-train-half.json").write_text(
        (BENCH / "checks" / "flagship-train.json").read_text())
    (bench / "metrics" / "traced_steps.train.py").write_text(
        "def read(r):\n    return None if r is None else float(r.units)\n")
    spec["workloads"].append({"name": "flagship-train-half", "config": "flagship",
                              "traffic": "train_half", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "traced_steps.train", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "train loop",
                              "moves": "train_samples_per_s",
                              "workloads": ["flagship-train-half"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = Cell("flagship-train-half", bench=bench)
    assert cell.traffic["batch_size"] == 250
    assert "traced_steps.train" in cell.readers
    assert Cell("flagship-train", bench=bench).readers.keys() >= {"mfu.train"}
    assert "traced_steps.train" not in Cell("flagship-train", bench=bench).readers


def test_benchmark_json_keeps_to_its_contract():
    """Names, units and lengths as the contract allows; every cell reports
    `setup_s`, another end-to-end metric and a per-layer one; every
    per-layer metric moves an end-to-end metric its cells report."""
    import re

    spec = load_json(BENCH.parent / "BENCHMARK.json")
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    cells = {w["name"]: w for w in spec["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for w in cells.values():
        assert name.match(w["name"]) and name.match(w["traffic"]) and len(w["why"]) <= 200
    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for c in m["workloads"]:
            assert reports(e2e[m["moves"]], c), (m["name"], c)
    for c in cells:
        got = [n for n, m in e2e.items() if reports(m, c)]
        assert "setup_s" in got and len(got) >= 2
        assert any(reports(m, c) for m in spec["per_layer"])
