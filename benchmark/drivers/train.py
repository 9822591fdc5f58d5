"""Training: the program's `Trainer.train_epoch` over the pool's batches.

Set-up builds one `Trainer` (the configuration's recipe, the model with
the weights drawn from the seed, AdamW on the one-cycle schedule, no
checkpoints) and drives it through its first `check_steps` steps on
different pool batches, through the same `train_epoch` and loader as the
window: step 1 alone, so that the first gradient can be read from the
optimizer's state, then the rest.  Those steps warm up every shape.  The
window is `train_epoch` of the next epoch, cycling the pool until the first
step that ends `--seconds` after its start.  After it, with the program's
state freed, the plain reference follows the set-up's steps from the same
weights, batches and augmentation draws.

`train_samples_per_s` is every sample of the window's steps over the
window's time (all ranks' samples where there are several).

On several cards (`ctx.world` > 1, one process a card) the benchmark
starts the process group (NCCL; gloo on the CPU) before the program sees
it, each rank trains on its own share of each global batch, rank 0 decides
when the window ends and tells the others over a gloo group, and the
reference runs on every rank over its rows, with the features gathered and
the gradients summed, so that it follows the global batch.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from benchmark.core import counts, inputs
from benchmark.core.loader import PoolLoader
from benchmark.core.program import build_model, free, leaf_norms, to_device_batch
from benchmark.core.trace import Reading, TraceSession
from benchmark.core.weights import draw_weights

MODE = "train"


def schedule_args(mc, world: int, epoch_batches: int):
    o = mc.optim
    lr = o.lr_config
    scale = mc.batch_size * world / o.base_batch_size if o.scale_lr_by_batch else 1.0
    return dict(max_lr=lr.max_lr * scale, total_steps=max(epoch_batches * mc.epochs, 1),
                pct_start=lr.pct_start, div_factor=lr.div_factor,
                final_div_factor=lr.final_div_factor)


@contextlib.contextmanager
def first_features(into: dict):
    """Keep, on the host, the unit features the program's train step
    computes while inside (the tri-encoder's output, `clibd_apply`)."""
    from clibd_tpu_torch.engine import train

    real = train.clibd_apply

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        for m in ("image", "dna", "language"):
            if out.get(m) is not None and m not in into:
                into[m] = out[m].detach().double().cpu().numpy()
        return out

    train.clibd_apply = recording
    try:
        yield
    finally:
        train.clibd_apply = real


def program_setup(ctx, gcfg, pool, weights, steps: int):
    """The Trainer, driven through its first `steps` steps; → (trainer,
    loader, readings {"losses", "grad", "grad_t", "change", "features"}):
    the losses, the first gradient from the optimizer's state (its leaf
    norms, and the host tensors), the change of every parameter after the
    steps (host tensors) and the first step's unit features."""
    from clibd_tpu_torch.engine.train import Trainer

    mc = gcfg.model_config
    t = ctx.cell.traffic
    model = build_model(mc, weights, ctx.device)
    ctx.mark("program model")
    by_param = {id(p): n for n, p in model.named_parameters()}
    loader = PoolLoader(pool, t["epoch_batches"], mc.batch_size)
    losses = []

    def log(d):
        if "loss" in d:
            losses.append(float(d["loss"]))

    trainer = Trainer(gcfg, None, ctx.scratch, model=model, train_loader=loader, log_fn=log,
                      device=ctx.device)
    ctx.mark("model")
    loader.plan(1)
    features: dict = {}
    with first_features(features):
        trainer.train_epoch(0)
    ctx.mark("step 1")
    state = trainer.optimizer.state
    grad_t = {by_param[id(p)]: (state[p]["exp_avg"] / (1.0 - mc.optim.beta1)).cpu()
              for p in state}
    if steps > 1:
        loader.plan(steps - 1)
        trainer.train_epoch(0, start_batch=1)
    change = {n: (p.detach() - weights[n]).cpu() for n, p in model.named_parameters()}
    return trainer, loader, {"losses": losses[:steps], "grad": leaf_norms(grad_t),
                             "grad_t": grad_t, "change": change, "features": features}


def start_group(ctx):
    """The ranks' process group, and agree(stop) → rank 0's decision."""
    import torch
    import torch.distributed as dist

    from benchmark.core.ranks import rank_env

    env = rank_env()
    dist.init_process_group("nccl" if ctx.device.type == "cuda" else "gloo",
                            init_method=f"tcp://{env['addr']}:{env['port']}",
                            rank=env["rank"], world_size=env["world"])
    host = dist.new_group(backend="gloo")

    def agree(stop: bool) -> bool:
        flag = torch.tensor([int(stop)])
        dist.broadcast(flag, src=0, group=host)
        return bool(flag.item())

    def reduce(value: float, op) -> float:
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=op, group=host)
        return float(t.item())

    return dist.group.WORLD, agree, reduce


def reference_readings(ctx, pool, mc, steps: int, precision: str = "fp32") -> dict:
    """The plain reference's losses, first gradient (norms, and the
    tensors as "grad_t"), change (tensors) and first step's unit features
    (this rank's rows) over the set-up's steps, from the weights drawn
    again.  A recipe whose settings differ from those the configuration's
    reference declares it implements (its `SETTINGS`) is refused."""
    import torch

    from benchmark.core.cell import config_value

    ref = ctx.cell.reference
    other = {k: config_value(mc, k) for k, v in ref.SETTINGS.items()
             if config_value(mc, k) != v}
    if other:
        raise ValueError(f"the plain reference does not implement {other}")
    ref.no_tf32()
    widths = ctx.cell.widths
    shapes = ref.param_shapes(widths)
    P = draw_weights(shapes, ref.init_kind, ctx.seed, ctx.device)
    sched = ref.one_cycle(**schedule_args(mc, ctx.world, ctx.cell.traffic["epoch_batches"]))
    o = mc.optim
    state: dict = {}
    losses, grad_t = [], None
    for k in range(steps):
        b = to_device_batch(pool[k], ctx.device)
        gen = torch.Generator(device=ctx.device).manual_seed(
            ref.batch_generator_seed(ctx.seed, 0, k, ctx.rank if ctx.world > 1 else None))
        images = None
        if "image" in b:
            images = ref.augment(b["image"].float() / 255.0, gen)
        loss, grads, feats = ref.loss_and_grads(P, widths, images, b.get("dna"),
                                                b.get("language"), b["label"],
                                                ctx.cell.checks["block_rows"], precision, ctx.group)
        losses.append(float(loss))
        if k == 0:
            grad_t = grads
            features = {m: f.double().cpu().numpy() for m, f in feats.items()}
        ref.adamw_update(P, grads, state, sched(k), o.beta1, o.beta2, o.eps, o.weight_decay)
        del grads
    del state
    P0 = draw_weights(shapes, ref.init_kind, ctx.seed, ctx.device)
    change = {n: P[n] - P0[n] for n in P}
    return {"losses": losses, "grad": leaf_norms(grad_t), "grad_t": grad_t, "change": change,
            "features": features}


def check_numbers(prog: dict, refr: dict, detail: bool = False) -> dict:
    """The numbers compared; with detail, also each step's loss gap and the
    worst and median leaves of the gradient's, its direction's and the
    change's gaps."""
    from benchmark.core.compare import (direction_gaps, leaf_gaps, moved_change_norms, row_gaps,
                                        train_numbers)

    p_change, r_change = moved_change_norms(prog["change"], refr["change"], refr["grad_t"])
    numbers = train_numbers(dict(prog, change=p_change), dict(refr, change=r_change))
    numbers.update(row_gaps(prog["features"], refr["features"]))
    if detail:
        numbers = {"numbers": numbers,
                   "loss_steps": [abs(p - r) / abs(r)
                                  for p, r in zip(prog["losses"], refr["losses"])]}
        for key, gaps in (("grad", leaf_gaps(prog["grad"], refr["grad"])),
                          ("grad_dir", direction_gaps(prog["grad_t"], refr["grad_t"])),
                          ("change", leaf_gaps(p_change, r_change))):
            order = sorted(gaps, key=lambda n: -gaps[n])
            numbers[key] = {"worst": [[n, gaps[n]] for n in order[:4]],
                            "median": float(np.median(list(gaps.values())))}
    return numbers


def traced_counts(ctx, pool, sequence, mc, peaks):
    total = None
    for p in sequence:
        total = counts.add_counts(total, counts.batch_counts(
            ctx.cell.widths, pool[p], MODE, bool(mc.remat), peaks))
    return total


def run(ctx) -> dict:
    import torch
    import torch.distributed as dist

    cell, t = ctx.cell, ctx.cell.traffic
    agree = reduce = None
    if ctx.world > 1:
        ctx.group, agree, reduce = start_group(ctx)
    gcfg = ctx.program_config()
    mc = gcfg.model_config
    ctx.mark("program config")
    if mc.batch_size != t["batch_size"]:
        raise ValueError(f"traffic batch {t['batch_size']} is not the recipe's {mc.batch_size}")
    steps = int(cell.checks["check_steps"])
    if t["pool_batches"] < steps:
        raise ValueError("the pool has fewer batches than the steps checked")
    ref = cell.reference
    pool = inputs.make_pool(cell.widths, ctx.seed, t["pool_batches"], mc.batch_size,
                            t["modalities"], ctx.rank, ctx.world)
    ctx.mark("pool")
    weights = draw_weights(ref.param_shapes(cell.widths), ref.init_kind, ctx.seed, ctx.device)
    ctx.sync()
    ctx.mark("weights")
    trainer, loader, prog = program_setup(ctx, gcfg, pool, weights, steps)
    loader.agree = agree
    del weights
    ctx.sync()
    if ctx.world > 1:
        dist.barrier()
    setup_s = time.time() - ctx.t_start
    ctx.mark("setup")

    session = TraceSession(t["trace_start"], t["trace_units"], ctx.sync) if ctx.trace else None
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.sync()
    t0 = time.perf_counter()
    loader.window(t0, ctx.seconds, session)
    trainer.train_epoch(1)
    ctx.sync()
    elapsed = time.perf_counter() - t0
    if session is not None:
        session.finish()
    steps_run = len(loader.sequence)
    loader_asked = loader.asked
    samples = steps_run * mc.batch_size * ctx.world
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    reading = None
    if session is not None and session.events is not None:
        traced = [loader.sequence[i] for i in session.traced]
        reading = Reading(MODE, session.events, session.window_s, len(traced),
                          len(traced) * mc.batch_size * ctx.world,
                          traced_counts(ctx, pool, traced, mc, ctx.peaks), ctx.peaks, cell.chips)
    if reduce is not None:
        peak = int(reduce(peak, dist.ReduceOp.MAX))
        if reading is not None:
            # busy time averaged over the cards, the model's work every
            # rank's; the kernels' rooflines stay rank 0's
            reading.busy_s = reduce(reading.busy_s, dist.ReduceOp.SUM) / ctx.world
            reading.counts["model"]["flops"] *= ctx.world
    trainer.close()
    del trainer, loader
    free()
    ctx.mark("window and trace")

    refr = reference_readings(ctx, pool, mc, steps)
    numbers = check_numbers(prog, refr)
    if reduce is not None:
        # each rank compared its own rows' features: the worst rank's
        numbers = {k: reduce(v, dist.ReduceOp.MAX) for k, v in numbers.items()}
    ctx.mark("reference")
    if ctx.world > 1:
        dist.destroy_process_group()
    return {"e2e": {"train_samples_per_s": samples / elapsed,
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "attempted": steps_run, "failed": 0, "numbers": numbers,
            "memory_peak_bytes": peak, "reading": reading,
            "window": {"steps": steps_run, "seconds": elapsed, "samples": samples,
                       "asked_s": [round(t, 4) for t in loader_asked]}}
