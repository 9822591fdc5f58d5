"""The whole run on a card, and the refusals of a run without one."""

import json
import subprocess
import sys

import pytest

from benchmark.core.cell import BENCH

ROOT = BENCH.parent


def run(*args, cwd=ROOT, timeout=900):
    return subprocess.run([sys.executable, str(BENCH / "run.py"), *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    """Without a CUDA card (this test's condition) the run prints no result
    and exits with another code than 0."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    got = run("--workload", "flagship-embed", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_unknown_cell_no_result():
    got = run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert got.returncode != 0 and got.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_embed_cell_on_the_card(card, trace):
    got = run("--workload", "flagship-embed", "--seed", "2147483659", "--seconds", "3",
              "--trace", trace)
    assert got.returncode == 0, got.stderr[-4000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    if trace == "1":
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"embed_samples_per_s", "peak_mem_gib", "setup_s"}
