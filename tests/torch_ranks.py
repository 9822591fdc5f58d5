"""gloo ranks on the CPU for the port's multi-rank tests.

`run_ranks(world, tasks, data, tmp)` starts `world` processes of this file
(`python tests/torch_ranks.py <payload> <outdir>`) with torchrun's
environment on a free localhost port, each pinned to one torch thread; every
rank starts its group through `parallel.maybe_initialize_distributed("cpu")`,
runs the named tasks on the payload's data and saves what they return to
`outdir/rank<r>.pt`.  A rank that fails, hangs past the timeout or exits
non-zero fails the call, and every process is stopped.  This file imports
neither jax nor the JAX package: the ranks run the port alone, and the
tests hold what they return against `clibd_tpu` in the pytest process.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def run_ranks(world: int, tasks, data: dict, tmp: Path, timeout: float = 240) -> list:
    """→ [rank r's {task: result}] for r in range(world)."""
    tmp.mkdir(parents=True, exist_ok=True)
    payload = tmp / "payload.pt"
    torch.save({"tasks": list(tasks), "data": data}, payload)
    from clibd_tpu_torch.parallel import free_port

    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.pop("CLIBD_DISABLE_DISTRIBUTED", None)
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__)), str(payload),
                                       str(tmp)], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a rank ran past {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# -- tasks (run in the ranks) ------------------------------------------------


def task_parallel(mesh, data: dict, out_dir: Path) -> dict:
    """The helpers of parallel/mesh.py on rank-dependent inputs."""
    import torch.distributed as dist

    from clibd_tpu_torch.parallel import (all_gather_with_grad, all_hosts_agree,
                                          all_reduce_grads, broadcast_from_main, local_shard)

    r = mesh.rank
    x = torch.from_numpy(data["x"][r]).requires_grad_()
    y = all_gather_with_grad(x, mesh.group)
    (y * torch.from_numpy(data["w"][r])).sum().backward()
    tree = {"params": {"qkv": torch.full((3, 2), r + 0.5), "ids": torch.arange(4) * (r + 1)},
            "opt": {"mu": np.full(5, r, np.float32), "count": np.asarray(r + 7, np.int32)},
            "ints": [r + 1, (r + 2, r + 3)], "metric": r + 0.25, "flag": bool(r)}
    reduced = {}
    for op in ("mean", "sum"):
        params = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2, 2)),
                  torch.nn.Parameter(torch.zeros(1))]
        params[0].grad = torch.full((3,), float(r + 1))
        params[1].grad = torch.arange(4.0).view(2, 2) * (r + 1)
        all_reduce_grads(params, op, mesh.group)
        reduced[op] = [None if p.grad is None else p.grad.clone() for p in params]
    return {"backend": dist.get_backend(mesh.group), "rank": r, "world": mesh.size,
            "gathered": y.detach(), "x_grad": x.grad,
            "agree_all": all_hosts_agree(True, mesh.group),
            "agree_one_false": all_hosts_agree(r == 0, mesh.group),
            "broadcast": broadcast_from_main(tree, mesh.group), "reduced": reduced,
            "shard": local_shard(mesh, {"a": np.arange(8).reshape(4, 2)})}


def task_sharded_loss(mesh, data: dict, out_dir: Path) -> dict:
    """sharded_clip_loss of this rank's rows, each case: the loss and its
    gradients with respect to the rank's features and the logit scale."""
    from clibd_tpu_torch.ops.loss import sharded_clip_loss
    from clibd_tpu_torch.parallel import local_shard

    out = {}
    for name, case in data["cases"].items():
        rows = local_shard(mesh, {"labels": case["labels"], **{m: f for m, f in
                                                             case["features"].items()}})
        feats = {m: torch.from_numpy(rows[m]).requires_grad_() for m in case["features"]}
        scale = torch.tensor(case["scale"], requires_grad=True)
        loss = sharded_clip_loss(feats, torch.from_numpy(rows["labels"]), scale, case["cfg"],
                                 mesh.group)
        grads = torch.autograd.grad(loss, [*feats.values(), scale])
        out[name] = {"loss": loss.detach(), "scale_grad": grads[-1],
                     "grads": dict(zip(feats, grads[:-1]))}
    return out


def _identity_augment():
    from clibd_tpu_torch.engine import simclr, train

    train.train_augment = lambda generator, x: x
    simclr.simclr_augment = lambda generator, x, size: x


def task_train_step(mesh, data: dict, out_dir: Path) -> dict:
    """Two multi-rank updates of the tiny model from the payload's weights,
    the augmentation the identity: the params before each step and after
    the last, each step's loss and averaged gradients."""
    from clibd_tpu_torch.engine import train
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.models import CLIBD, set_trainable
    from clibd_tpu_torch.parallel import local_shard

    _identity_augment()
    cfg = data["cfg"]
    model = set_trainable(CLIBD(cfg), cfg)
    model.load_state_dict(data["state"])
    opt = train.build_optimizer(cfg, model, lambda i: data["lr"])
    grad_fn = train.make_sharded_grad_fn(cfg, model, mesh)

    def params():
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    out = {"params": [params()], "losses": [], "grads": []}
    for i, batch in enumerate(data["batches"]):
        opt.zero_grad(set_to_none=True)
        gen = train.batch_generator(torch.device("cpu"), 0, 0, i)
        out["losses"].append(grad_fn(to_device(local_shard(mesh, batch), torch.device("cpu")),
                                     gen))
        out["grads"].append({n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None})
        opt.step()
        out["params"].append(params())
    return out


def task_accum_step(mesh, data: dict, out_dir: Path) -> dict:
    """The gradient cache across the ranks (`make_accum_grad_fn(mesh=)`, k
    microbatches of this rank's rows) and the multi-rank monolithic step
    (`make_sharded_grad_fn`) from the payload's weights on each global
    batch, the augmentation the identity: each one's loss and gradients;
    then one update of `make_train_step_accum(mesh=)`'s step."""
    from clibd_tpu_torch.engine import train
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.models import CLIBD, set_trainable
    from clibd_tpu_torch.parallel import local_shard

    _identity_augment()
    cfg, k = data["cfg"], data["accum_k"]
    model = set_trainable(CLIBD(cfg), cfg)
    model.load_state_dict(data["state"])
    cpu = torch.device("cpu")

    def grads():
        out = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    out = {"accum": [], "mono": []}
    for i, batch in enumerate(data["accum_batches"]):
        local = to_device(local_shard(mesh, batch), cpu)
        gen = train.batch_generator(cpu, 0, 0, i)
        for name, fn in (("accum", train.make_accum_grad_fn(cfg, model, k, mesh)),
                         ("mono", train.make_sharded_grad_fn(cfg, model, mesh))):
            loss = fn(local, gen)
            out[name].append({"loss": loss, "grads": grads()})
    opt = train.build_optimizer(cfg, model, lambda i: data["lr"])
    step = train.make_train_step_accum(cfg, model, opt, k, mesh)
    step(to_device(local_shard(mesh, data["accum_batches"][0]), cpu), None)
    out["step_qualname"] = step.__qualname__
    out["params_after"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out


def task_accum_trainer(mesh, data: dict, out_dir: Path) -> dict:
    """`Trainer.fit` at W ranks with accum_steps > 1 (one epoch, no eval),
    then `resume_multihost` of rank 0's last/ into a fresh such trainer."""
    import copy

    from clibd_tpu_torch.config.schema import GlobalConfig
    from clibd_tpu_torch.engine import train

    cfg = copy.deepcopy(data["trainer_cfg"])
    cfg.accum_steps, cfg.eval_skip_epoch = data["accum_k"], 10
    gcfg = GlobalConfig()
    gcfg.model_config = cfg
    split = _split(cfg, "train", data["trainer_rows"]["train"], 0, cfg.batch_size, mesh,
                   drop_last=True)
    own = out_dir / f"accum{mesh.rank}"
    trainer = train.Trainer(gcfg, None, str(own), train_loader=split, device="cpu", mesh=mesh)
    qualname = trainer.step_fn.__qualname__
    history = trainer.fit()
    trainer.close()
    cfg.default_seed += 1
    fresh = train.Trainer(gcfg, None, str(out_dir / f"accum_fresh{mesh.rank}"),
                          train_loader=split, device="cpu", mesh=mesh)
    fresh.resume_multihost(str(out_dir / "accum0" / "last"))
    return {"qualname": qualname, "losses": history["loss"], "resume_step": fresh.global_step,
            "params": {n: p.detach().clone() for n, p in fresh.model.named_parameters()}}


def _split(cfg, name: str, n: int, seed: int, batch: int, mesh, drop_last: bool = False):
    from clibd_tpu_torch.data import SyntheticSplit

    return SyntheticSplit(name, n, cfg, seed=seed, batch_size=batch, host_id=mesh.rank,
                          num_hosts=mesh.size, drop_last=drop_last)


def task_trainer(mesh, data: dict, out_dir: Path) -> dict:
    """`Trainer.fit` at W ranks over host-sharded synthetic splits, every
    rank with its own output directory; then `resume_multihost` on fresh
    trainers, rank 1 holding a stale last/ of its own."""
    from clibd_tpu_torch.config.schema import GlobalConfig
    from clibd_tpu_torch.engine import train
    from clibd_tpu_torch.engine.checkpoint import save_train_state
    from clibd_tpu_torch.parallel import create_mesh

    cfg = data["trainer_cfg"]
    gcfg = GlobalConfig()
    gcfg.model_config = cfg
    rows = data["trainer_rows"]
    train_split = _split(cfg, "train", rows["train"], 0, cfg.batch_size, mesh, drop_last=True)

    def factory(split, is_train, host_id=0, num_hosts=1):
        assert (host_id, num_hosts) == (mesh.rank, mesh.size)
        return _split(cfg, split, rows[split], 1 + sorted(rows).index(split), cfg.batch_size,
                      mesh)

    own = out_dir / f"out{mesh.rank}"
    trainer = train.Trainer(gcfg, None, str(own), train_loader=train_split,
                            eval_loader_factory=factory, device="cpu", mesh=mesh)
    history = trainer.fit()
    trainer.close()
    written = sorted(str(p.relative_to(own)) for p in own.rglob("*") if p.is_file()) \
        if own.exists() else []

    if mesh.rank == 1:  # a stale last/ of another run at the same path
        stale = train.Trainer(gcfg, None, str(out_dir / "stale"), train_loader=train_split,
                              mesh=create_mesh(devices=["cpu"]))
        with torch.no_grad():
            for p in stale.model.parameters():
                p.add_(1.0)
        save_train_state(str(own / "last"), stale.model, stale.optimizer, step=99, epoch=5)
    cfg.default_seed += 1  # the fresh trainers start from other weights
    fresh = train.Trainer(gcfg, None, str(out_dir / f"fresh{mesh.rank}"),
                          train_loader=train_split, eval_loader_factory=factory, device="cpu",
                          mesh=mesh)
    epoch = fresh.resume_multihost(str(own / "last"))
    opt_state = {n: {k: v.clone() for k, v in fresh.optimizer.state[p].items()}
                 for n, p in fresh.model.named_parameters() if p in fresh.optimizer.state}
    none_epoch = fresh.resume_multihost(str(out_dir / "nowhere"))
    return {"history": history, "written": written, "resume_epoch": epoch,
            "resume_step": fresh.global_step, "update_count": fresh.optimizer.update_count(),
            "params": {n: p.detach().clone() for n, p in fresh.model.named_parameters()},
            "opt_state": opt_state, "none_epoch": none_epoch,
            "world_size": trainer.world_size}


def task_extract(mesh, data: dict, out_dir: Path) -> dict:
    """`extract_split_multihost` of an odd-sized synthetic split."""
    from clibd_tpu_torch.engine.extract import extract_split_multihost
    from clibd_tpu_torch.models import CLIBD

    cfg = data["cfg"]
    model = CLIBD(cfg)
    model.load_state_dict(data["state"])

    def make_loader(host_id, num_hosts):
        from clibd_tpu_torch.data import SyntheticSplit

        return SyntheticSplit("all_keys", data["extract_rows"], cfg, seed=3,
                              batch_size=data["extract_batch"], host_id=host_id,
                              num_hosts=num_hosts)

    return extract_split_multihost(model, cfg, None, "all_keys", None, for_key_set=True,
                                   make_loader=make_loader, mesh=mesh)


def task_simclr_step(mesh, data: dict, out_dir: Path) -> dict:
    """One data-parallel SimCLR update of the tiny ViT, augmentation the
    identity: the loss, the summed gradients and the parameters after."""
    from clibd_tpu_torch.engine import simclr, train
    from clibd_tpu_torch.models.vit import ViT
    from clibd_tpu_torch.parallel import local_shard

    _identity_augment()
    data = data["simclr"]
    cfg = data["cfg"]
    model = ViT(cfg.image.vit, output_dim=data["output_dim"], lora_rank=0)
    model.load_state_dict(data["state"])
    opt = train.ScheduledAdam(model.parameters(), lambda i: data["lr"],
                              weight_decay=data["weight_decay"])
    grad_fn = simclr.make_simclr_grad_fn(cfg, model, data["temperature"], mesh)
    views = local_shard(mesh, {"v1": data["v1"], "v2": data["v2"]})
    gen = train.batch_generator(torch.device("cpu"), 0, 0, 0)
    loss = grad_fn(torch.from_numpy(views["v1"]), torch.from_numpy(views["v2"]), gen)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    return {"loss": loss, "grads": grads,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


TASKS = {"parallel": task_parallel, "sharded_loss": task_sharded_loss,
         "train_step": task_train_step, "trainer": task_trainer, "extract": task_extract,
         "simclr_step": task_simclr_step, "accum_step": task_accum_step,
         "accum_trainer": task_accum_trainer}


def main(payload_path: str, out_dir: str) -> int:
    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from clibd_tpu_torch.parallel import create_mesh, maybe_initialize_distributed

    assert maybe_initialize_distributed("cpu")
    try:
        payload = torch.load(payload_path, weights_only=False)
        mesh = create_mesh(device="cpu")
        results = {name: TASKS[name](mesh, payload["data"], Path(out_dir))
                   for name in payload["tasks"]}
        torch.save(results, Path(out_dir) / f"rank{mesh.rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
