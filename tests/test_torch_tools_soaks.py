"""The extraction and serving soaks of `clibd_tpu_torch/tools/` on the CPU
at a tiny width (`soak_train.TINY`, `soak_serve --cpu`):

- `soak_extract`: build, `run` (the port's `eval` end to end and the
  device-only encode), `verify` (the cache's schema, its reload, and a
  second `eval` over the cache with the same acc_dict), then `extract
  --stream` killed with SIGKILL past a record count in a subprocess,
  resumed, and equal to an uninterrupted stream bit for bit (its stream
  leg against the JAX script's: tests/test_torch_tools_soak_parity.py);
- `soak_serve`: the three writer patterns against the resident service's
  reload watch under client load: no 5xx, at least two reloads, the
  served gallery at the last row count written.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from clibd_tpu_torch.tools import soak_extract, soak_serve

REPO = Path(__file__).resolve().parents[1]
# the torch threads of every leg, in this process and in the killed one: the
# CPU's products round by their thread count, and the legs must agree bit for bit
THREADS = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _stream(work, *extra):
    """`soak_extract stream` in a process of its own, as a user runs it: the
    three streaming legs then run in the same environment, thread count
    included, whatever this worker ran before."""
    return subprocess.run([sys.executable, "-m", "clibd_tpu_torch.tools.soak_extract", "stream",
                           "--workdir", str(work), "--device", "cpu", *extra],
                          cwd=work, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO),
                               "OMP_NUM_THREADS": str(THREADS)})


def test_soak_extract_legs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # `eval` writes logs/ where it runs
    monkeypatch.delenv("CLIBD_EVAL_TIMING", raising=False)
    work = tmp_path / "work"
    p = soak_extract.Paths(str(work))
    work.mkdir()
    soak_extract.build(p, "cpu")
    assert p.split_sizes() == {"all_keys": 60, "test_seen": 36, "test_unseen": 24}
    summary = soak_extract.run(p, device="cpu")
    assert summary["records"] == 120 and summary["batch_size"] == 8
    assert summary["extraction_wall_s"] > 0 and summary["per_split_final_rates"]
    assert summary["device"] == "cpu" and summary["card"] is None
    assert soak_extract.verify(p, device="cpu")["acc_dict"]
    oneshot = _stream(work, "--out", p.oneshot)
    assert oneshot.returncode == 0, oneshot.stdout[-2000:] + oneshot.stderr[-2000:]
    killed = _stream(work, "--kill-at", "16")
    assert killed.returncode == -9, killed.stdout[-2000:] + killed.stderr[-2000:]
    assert "SIGKILL at >=16 records" in killed.stdout
    resumed = _stream(work, "--resume")
    assert resumed.returncode == 0, resumed.stdout[-2000:] + resumed.stderr[-2000:]
    assert soak_extract.stream_compare(p) == {"rows": 60}


def test_soak_serve_on_the_cpu(tmp_path):
    verdict = soak_serve.soak(cpu=True, seconds=4.0, clients=2, write_period=0.5,
                              workdir=str(tmp_path))
    assert verdict["ok"], verdict
    assert verdict["requests"]["5xx"] == 0 and verdict["reloads"] >= 2
    assert verdict["final_keys_served"] == verdict["final_keys_written"]

