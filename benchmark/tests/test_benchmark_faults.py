"""A run with the timed path broken underneath comes out not correct: the
rest of a run on the CPU at test sizes (no look for a card), once for each
fault the cell can have, against the cell's own limits."""

import contextlib

import pytest
import torch

from benchmark.tests.sizes import run_tiny, tiny_cell


@contextlib.contextmanager
def frozen_state():
    """A train step that returns its state unchanged: the optimizer does
    nothing."""
    from clibd_tpu_torch.engine import train

    real = train.build_optimizer

    def build(cfg, model, schedule):
        opt = real(cfg, model, schedule)
        opt.step = lambda closure=None: None
        return opt

    train.build_optimizer = build
    try:
        yield
    finally:
        train.build_optimizer = real


@contextlib.contextmanager
def half_batch_step():
    from benchmark.calibrate import half_batch

    with half_batch():
        yield


@contextlib.contextmanager
def altered_answer():
    """One embedding of every batch altered where it is produced."""
    from clibd_tpu_torch.engine import extract

    real = extract.make_encode_step

    def make(cfg, model, compute_dtype=torch.bfloat16):
        step = real(cfg, model, compute_dtype)

        def altered(batch):
            out = step(batch)
            out["image"] = out["image"].clone()
            out["image"][0] = -out["image"][0]
            return out

        return altered

    extract.make_encode_step = make
    try:
        yield
    finally:
        extract.make_encode_step = real


@contextlib.contextmanager
def half_rows():
    """Half of each batch left out of what is returned."""
    from clibd_tpu_torch.engine import extract

    real = extract.make_encode_step

    def make(cfg, model, compute_dtype=torch.bfloat16):
        step = real(cfg, model, compute_dtype)

        def halved(batch):
            out = step(batch)
            return {k: v[: v.shape[0] // 2] for k, v in out.items()}

        return halved

    extract.make_encode_step = make
    try:
        yield
    finally:
        extract.make_encode_step = real


@contextlib.contextmanager
def wrong_attn_backward():
    """Every attention backward's dqkv handed to the batch's next row."""
    from benchmark.calibrate import attn_bwd

    with attn_bwd():
        yield


@contextlib.contextmanager
def wrong_key_tiled_backward():
    """The same in the key-tiled backward's calls alone (DNA N 657)."""
    from benchmark.calibrate import WHOLE_ROW_KEYS, attn_bwd

    with attn_bwd(WHOLE_ROW_KEYS):
        yield


CASES = [("flagship-train", frozen_state), ("flagship-train", half_batch_step),
         ("overlap-train", half_batch_step), ("flagship-train", wrong_attn_backward),
         ("overlap-train", wrong_key_tiled_backward), ("flagship-embed", altered_answer),
         ("flagship-embed", half_rows)]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    with fault():
        result = run_tiny(cell, seconds=0.3)
    assert result["failed"] or not all(c["ok"] for c in result["checks"].values()), \
        result["checks"]


@pytest.mark.parametrize("fault", ["none", "no_exchange", "no_grad_exchange"])
def test_four_ranks(fault):
    """The train cell as four gloo ranks at test sizes: a sound run is
    correct against the reference run over the same ranks; with the
    exchange left out (each rank's loss over its own rows, its own
    gradients kept), or the gradients' all-reduce alone, a data-parallel
    cell's faults, it is not."""
    import json
    import subprocess
    import sys

    from benchmark.core.cell import ROOT

    got = subprocess.run([sys.executable, "-m", "benchmark.tests.ranks_cpu", "flagship-train",
                          fault], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    result = json.loads(got.stdout.strip().splitlines()[-1])
    correct = all(c["ok"] for c in result["checks"].values()) and not result["failed"]
    assert correct == (fault == "none"), result["checks"]
