"""The control comes out not correct: the plain reference put in the
program's place with every matmul of the encoders in float8 e4m3 (the
precision below the configuration's bf16), judged by the cell's own limits,
at test sizes on the CPU.  The readings at the cells' own sizes, on the
card, are `calibrate.py`'s."""

import pytest
import torch

from benchmark.core import compare, inputs
from benchmark.run import Context
from benchmark.tests.sizes import tiny_cell

CPU = torch.device("cpu")


def context(cell, seed, scratch):
    return Context(cell, seed, 0.0, False, CPU, 0.0, None, str(scratch), apply_widths=True)


@pytest.mark.parametrize("name", ["flagship-train", "overlap-train"])
def test_train_control_fails(name, tmp_path):
    cell = tiny_cell(name)
    ctx = context(cell, 424242, tmp_path)
    mc = ctx.program_config().model_config
    steps = int(cell.checks["check_steps"])
    pool = inputs.make_pool(cell.widths, ctx.seed, steps, mc.batch_size,
                            cell.traffic["modalities"])
    ref32 = cell.driver.reference_readings(ctx, pool, mc, steps)
    ctrl = cell.driver.reference_readings(ctx, pool, mc, steps, "fp8")
    checks = compare.judge(cell.driver.check_numbers(ctrl, ref32), cell.checks["limits"])
    assert not all(c["ok"] for c in checks.values()), checks


def test_embed_control_fails(tmp_path):
    cell = tiny_cell("flagship-embed")
    ctx = context(cell, 424242, tmp_path)
    pool = inputs.make_pool(cell.widths, ctx.seed, 2, 8, cell.traffic["modalities"])
    ref32 = cell.driver.reference_rows(ctx, pool)
    ctrl = cell.driver.reference_rows(ctx, pool, "fp8")
    flat = {m: v.reshape(-1, v.shape[-1]) for m, v in ref32.items()}
    got = compare.row_gaps({m: v.reshape(-1, v.shape[-1]) for m, v in ctrl.items()}, flat)
    checks = compare.judge(got, cell.checks["limits"])
    assert not all(c["ok"] for c in checks.values()), checks
