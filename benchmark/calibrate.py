"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... \
        [--control-seeds K] [--fault-seeds K] [--seconds S] [--out FILE]

For each seed, the numbers `correct` compares (`core/compare.py`):
- "program": the program against the plain float32 reference, as a run
  compares them (training: the set-up's steps, no window needed;
  embedding: a window of `--seconds`);
- "control" (the first K seeds): the reference itself in the program's
  place with every matmul of the encoders in float8 e4m3, the precision
  below the configuration's bf16;
- training only, the faults (the first K seeds): "half_batch", the program
  with half of each batch left out and the loss's mean taken over the
  rest; "attn_bwd", every attention backward's result handed to the batch's
  next row (wrong values, the right size); "attn_bwd_tiled", the same in
  the key-tiled backward's calls alone (N > 208 keys), where the cell has
  them; on several ranks also "no_exchange", the exchange between the ranks
  left out (each rank's loss over its own rows, its own gradients kept),
  and "no_grad_exchange", the gradients' all-reduce alone left out.  A
  state left unchanged reads 1 on `change_gap` by its measure and needs no
  run.

A cell on several cards runs as one rank a card (`core/ranks.py`); rank 0
prints.

A line of JSON a seed, then one with each number's lower reading (the
largest over the program's seeds) and the least reading of the control and
of each fault.  Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.run import T_START, Context, card  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The program's train step (one card's, or a rank's) on the first half
    of each batch's rows."""
    from clibd_tpu_torch.engine import train

    def halving(real):
        def make(*args):
            step = real(*args)

            def halved(batch, generator):
                rows = batch["label"].shape[0] // 2

                def cut(x):
                    return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) else x[:rows]

                return step(cut(batch), generator)

            return halved

        return make

    saved = train.make_train_step, train.make_train_step_shard_map
    train.make_train_step, train.make_train_step_shard_map = (halving(f) for f in saved)
    try:
        yield
    finally:
        train.make_train_step, train.make_train_step_shard_map = saved


@contextlib.contextmanager
def no_exchange():
    """The program's ranks without their exchange: no gathered features, no
    averaged gradients."""
    from clibd_tpu_torch.engine import train
    from clibd_tpu_torch.ops import loss

    saved = (train.all_reduce_grads, loss.all_gather_with_grad, loss.all_gather_tensor)
    train.all_reduce_grads = lambda params, op="mean", group=None: None
    loss.all_gather_with_grad = lambda x, group=None: x
    loss.all_gather_tensor = lambda x, group=None: x
    try:
        yield
    finally:
        train.all_reduce_grads, loss.all_gather_with_grad, loss.all_gather_tensor = saved


# the longest key count the attention backward takes as one whole row
# (`ops/attention.py::flash_attention_qkv_bwd_route`); beyond it, key-tiled
WHOLE_ROW_KEYS = 208


@contextlib.contextmanager
def attn_bwd(min_keys: int = 0):
    """The program's attention backward, in its calls of more than
    `min_keys` keys, with each row's dqkv handed to the batch's next row."""
    from clibd_tpu_torch.ops import attention

    real = attention._bwd_op

    def shifted(qkv, dout, mask_row, num_heads):
        dqkv = real(qkv, dout, mask_row, num_heads)
        return dqkv.roll(1, dims=0) if qkv.shape[1] > min_keys else dqkv

    attention._bwd_op = shifted
    try:
        yield
    finally:
        attention._bwd_op = real


@contextlib.contextmanager
def no_grad_exchange():
    """The program's ranks with the loss's exchange kept and the gradients'
    all-reduce left out: each rank steps on its own rows' gradients."""
    from clibd_tpu_torch.engine import train

    saved = train.all_reduce_grads
    train.all_reduce_grads = lambda params, op="mean", group=None: None
    try:
        yield
    finally:
        train.all_reduce_grads = saved


def train_faults(cell, batch: dict, world: int) -> dict:
    """The faults a train cell can have, by name, for its batches' shapes."""
    from benchmark.core.counts import towers

    faults = {"half_batch": half_batch, "attn_bwd": attn_bwd}
    if max(t["N"] for t in towers(cell.widths, batch)) > WHOLE_ROW_KEYS:
        faults["attn_bwd_tiled"] = lambda: attn_bwd(WHOLE_ROW_KEYS)
    if world > 1:
        faults.update(no_exchange=no_exchange, no_grad_exchange=no_grad_exchange)
    return faults


def train_seed(ctx, control: bool, fault: bool) -> dict:
    from benchmark.core import inputs
    from benchmark.core.program import free
    from benchmark.core.weights import draw_weights

    drv, cell = ctx.cell.driver, ctx.cell
    gcfg = ctx.program_config()
    mc = gcfg.model_config
    steps = int(cell.checks["check_steps"])
    t = cell.traffic
    pool = inputs.make_pool(cell.widths, ctx.seed, t["pool_batches"], mc.batch_size,
                            t["modalities"], ctx.rank, ctx.world)
    shapes = cell.reference.param_shapes(cell.widths)

    def program():
        weights = draw_weights(shapes, cell.reference.init_kind, ctx.seed, ctx.device)
        trainer, _, prog = drv.program_setup(ctx, gcfg, pool, weights, steps)
        trainer.close()
        del trainer, weights
        free()
        return prog

    readings = {"program": program()}
    if fault:
        for name, planted in train_faults(cell, pool[0], ctx.world).items():
            with planted():
                readings[name] = program()
    ref32 = drv.reference_readings(ctx, pool, mc, steps)
    out = {"losses": {"program": readings["program"]["losses"], "reference": ref32["losses"]}}
    if control:
        readings["control"] = drv.reference_readings(ctx, pool, mc, steps, "fp8")
    for kind, got in readings.items():
        d = drv.check_numbers(got, ref32, detail=True)
        out[kind] = d.pop("numbers")
        out[kind + "_detail"] = d
    return out


def embed_seed(ctx, control: bool) -> dict:
    from benchmark.core import compare, inputs

    drv, cell = ctx.cell.driver, ctx.cell
    result = drv.run(ctx)
    out = {"program": result["numbers"], "rows": result["attempted"]}
    if control:
        t = cell.traffic
        pool = inputs.make_pool(cell.widths, ctx.seed, t["pool_batches"], t["batch_size"],
                                t["modalities"])
        ref32 = drv.reference_rows(ctx, pool)
        ctrl = drv.reference_rows(ctx, pool, "fp8")
        flat = {m: v.reshape(-1, v.shape[-1]) for m, v in ref32.items()}
        out["control"] = compare.row_gaps({m: v.reshape(-1, v.shape[-1]) for m, v in ctrl.items()},
                                          flat)
    return out


FAULTS = ("half_batch", "attn_bwd", "attn_bwd_tiled", "no_exchange", "no_grad_exchange")


def summary(lines: list) -> dict:
    names = list(lines[0]["program"])
    out = {}
    for n in names:
        row = {"lower": max(line["program"][n] for line in lines)}
        for kind in [k for k in lines[0] if k in ("control", *FAULTS)]:
            vals = [line[kind][n] for line in lines if kind in line]
            if vals:
                row[kind] = min(vals)
        out[n] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import tempfile

    import torch

    from benchmark.core.cell import Cell, cache_dirs
    from benchmark.core.peaks import peaks_for
    from benchmark.core.ranks import is_rank, launch, rank_env
    from benchmark.run import loaded_forbidden

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    if cell.chips > 1 and not is_rank():
        return launch(os.path.abspath(__file__), list(argv if argv is not None else sys.argv[1:]),
                      cell.chips, T_START, loaded_forbidden, timeout_s=3600.0)
    cache_dirs()
    rank, world = (rank_env()["rank"], rank_env()["world"]) if is_rank() else (0, 1)
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dev = card(cell.chips)
    lines = []
    group = None
    with tempfile.TemporaryDirectory(prefix="bench_") as scratch:
        for i, seed in enumerate(args.seeds):
            t0 = time.time()
            ctx = Context(cell, seed, args.seconds, False, device, T_START, peaks_for(dev["kind"]),
                          scratch)
            ctx.rank, ctx.world = rank, world
            if world > 1:
                if group is None:
                    group = cell.driver.start_group(ctx)[0]
                ctx.group = group
            if cell.traffic["driver"] == "train":
                line = train_seed(ctx, i < args.control_seeds, i < args.fault_seeds)
            else:
                line = embed_seed(ctx, i < args.control_seeds)
            line.update(seed=seed, seconds=time.time() - t0, card=dev)
            lines.append(line)
            if rank == 0:
                print(json.dumps(line), flush=True)
    if rank:
        return 0
    total = {"summary": summary(lines), "workload": cell.name, "seeds": args.seeds}
    print(json.dumps(total), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines + [total]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
