"""Multi-rank dry run on the CPU: the counterpart of the JAX package's
`dryrun_multichip(n)`, with n gloo ranks in place of n virtual devices.

    python -m clibd_tpu_torch.tools.dryrun_multigpu 4

Starts n CPU processes on a free localhost port (one torch thread each) and,
on a tiny tri-modal model (2 layers, narrow widths, fp32) from one seed:

1. one multi-rank step (`make_train_step_shard_map`'s gradients, the batch
   split over the ranks) against the global-batch path on rank 0: the
   gradient cache over the same global batch with one microbatch a rank,
   which draws the same augmentation (`fold_in(generator, i)`): the losses
   within 1e-5 relative, every gradient within 1e-4 of its largest entry;
2. `sharded_clip_loss` against `clip_loss` of the gathered batch;
3. the query- and key-sharded kNN over n devices (the CPU named n times)
   against the one-device search, indices exact;
4. each rank's strided shard of a 103-row split: disjoint, equal sizes
   (drop_last), gathered on every rank;
5. `extract_split_multihost` of an odd 25-row split against `extract_split`
   on rank 0, and the retrieval grid over the gathered dicts.

Every rank runs under one deadline; a rank that fails, hangs or exits
non-zero fails the run, and the tool exits non-zero.  Prints one summary
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4      # of a tensor's largest entry: the same products, summed in another order
EMBED_ATOL = 1e-5    # a row encoded beside other rows


def tiny_config():
    """A narrow tri-modal model for ranks on the CPU."""
    from ..config import BertConfig, ExperimentConfig, ViTConfig

    mc = ExperimentConfig()
    mc.amp = False
    mc.disable_lora = True
    mc.batch_size = 2
    mc.output_dim = 16
    mc.image.vit = ViTConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=2,
                             num_heads=4, mlp_dim=64)
    mc.dna.max_bp = 80
    mc.dna.bert = BertConfig(vocab_size=1027, hidden_size=32, num_layers=2, num_heads=4,
                             intermediate_size=64, max_position_embeddings=40,
                             with_mlm_head=True)
    mc.language.bert = BertConfig(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                                  intermediate_size=32, max_position_embeddings=24)
    return mc


def _model(mc):
    from ..models import init_clibd_model

    return init_clibd_model(mc, torch.Generator().manual_seed(0), "cpu")


def _batch(split) -> dict:
    b = next(iter(split.batches()))
    return {k: b[k] for k in ("image", "dna", "language", "label")}


def _step_leg(mc, mesh) -> dict:
    """One multi-rank step's loss and gradients; on rank 0 the same from the
    gradient cache over the global batch."""
    from ..data import SyntheticSplit
    from ..engine import train
    from ..engine.extract import to_device
    from ..parallel import all_gather_tensor

    cpu = torch.device("cpu")
    n = mc.batch_size * mesh.size
    local = _batch(SyntheticSplit("train", n, mc, seed=1, batch_size=mc.batch_size,
                                  host_id=mesh.rank, num_hosts=mesh.size, drop_last=True))
    gen = train.batch_generator(cpu, mc.default_seed, 0, 0)
    model = _model(mc)
    loss = train.make_sharded_grad_fn(mc, model, mesh)(to_device(local, cpu), gen)
    grads = {n_: p.grad for n_, p in model.named_parameters() if p.grad is not None}
    out = {"loss": float(loss), "finite": bool(torch.isfinite(loss))}
    # the global batch in rank order: rank r's rows are microbatch r
    rows = {k: all_gather_tensor(v, mesh.group) if not isinstance(v, dict) else
            {kk: all_gather_tensor(vv, mesh.group) for kk, vv in v.items()}
            for k, v in to_device(local, cpu).items()}
    if mesh.rank == 0:
        ref = _model(mc)
        ref_loss = train.make_accum_grad_fn(mc, ref, mesh.size)(rows, gen)
        out["global_loss"] = float(ref_loss)
        assert abs(out["loss"] - out["global_loss"]) <= LOSS_RTOL * abs(out["global_loss"]), out
        for name, p in ref.named_parameters():
            if p.grad is None:
                continue
            err = float((grads[name] - p.grad).abs().max())
            assert err <= GRAD_TOL * float(p.grad.abs().max()) + 1e-12, (name, err)
        out["grads_checked"] = len(grads)
    return out


def _loss_leg(mc, mesh) -> dict:
    from ..ops.loss import clip_loss, sharded_clip_loss
    from ..parallel import local_shard

    rng = np.random.default_rng(2)
    b = 3 * mesh.size
    feats = {m: torch.from_numpy(rng.standard_normal((b, 16)).astype(np.float32))
             for m in ("image", "dna")}
    labels = torch.from_numpy(rng.integers(0, 4, b))
    whole = float(clip_loss(feats, labels, 10.0, mc.loss))
    mine = local_shard(mesh, {"labels": labels, **feats})
    sharded = float(sharded_clip_loss({m: mine[m] for m in feats}, mine["labels"], 10.0,
                                      mc.loss, mesh.group))
    assert abs(sharded - whole) < 1e-4, (sharded, whole)
    return {"sharded": sharded, "global": whole}


def _knn_leg(mesh) -> dict:
    from ..ops.knn import knn_search, prepare_keys

    rng = np.random.default_rng(3)
    q = rng.standard_normal((4 * mesh.size + 3, 16)).astype(np.float32)
    keys = rng.standard_normal((37, 16)).astype(np.float32)
    devices = ["cpu"] * mesh.size
    s1, i1 = knn_search(q, keys, k=5, device="cpu")
    s2, i2 = knn_search(q, keys, k=5, mesh=devices, shard="queries", device="cpu")
    s3, i3 = knn_search(q, prepare_keys(keys, mesh=devices), k=5, keys_normalized=True,
                        shard="keys")
    assert (i1 == i2).all() and (i1 == i3).all(), "sharded kNN disagrees with one device"
    assert np.allclose(s1, s2, atol=1e-6) and np.allclose(s1, s3, atol=1e-6)
    return {"queries": int(q.shape[0]), "keys": int(keys.shape[0])}


def _shard_leg(mesh) -> dict:
    from ..data.pipeline import shard_indices
    from ..parallel import all_gather_tensor

    n_records = 103
    mine = shard_indices(n_records, epoch=3, host_id=mesh.rank, num_hosts=mesh.size,
                         batch_size=5, shuffle=True, seed=42, drop_last=True)
    every = all_gather_tensor(torch.from_numpy(mine), mesh.group).numpy()
    assert len(mine) == (n_records // mesh.size) // 5 * 5
    assert len(np.unique(every)) == len(every), "rank shards overlap"
    return {"covered": int(len(every)), "records": n_records}


def _extract_leg(mc, mesh) -> dict:
    from ..data import SyntheticSplit
    from ..engine.evaluate import compute_overall_acc, inference_and_eval
    from ..engine.extract import extract_split, extract_split_multihost

    model = _model(mc)
    rows = {"all_keys": 25, "val_seen": 9, "val_unseen": 7}

    def run(split, for_key=False):
        return extract_split_multihost(
            model, mc, None, split, None, for_key_set=for_key, mesh=mesh,
            make_loader=lambda g, w: SyntheticSplit(split, rows[split], mc, seed=len(split),
                                                    batch_size=4, host_id=g, num_hosts=w))

    keys = run("all_keys", for_key=True)
    if mesh.rank == 0:
        want = extract_split(model, mc, SyntheticSplit("all_keys", 25, mc, seed=8,
                                                       batch_size=4), for_key_set=True)
        for k in ("encoded_image_feature", "encoded_dna_feature", "encoded_language_feature"):
            assert np.abs(keys[k] - want[k]).max() <= EMBED_ATOL, k
        assert keys["label_list"] == want["label_list"]
    acc, _, _ = inference_and_eval(keys, run("val_seen"), run("val_unseen"), with_preds=False,
                                   device="cpu")
    overall = float(compute_overall_acc(acc))
    assert np.isfinite(overall)
    return {"rows": int(keys["encoded_image_feature"].shape[0]), "overall_acc": overall}


def _rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ..parallel import create_mesh, maybe_initialize_distributed

    maybe_initialize_distributed("cpu")
    try:
        mesh = create_mesh(device="cpu")
        mc = tiny_config()
        result = {"step": _step_leg(mc, mesh), "loss": _loss_leg(mc, mesh),
                  "knn": _knn_leg(mesh), "shards": _shard_leg(mesh),
                  "extract": _extract_leg(mc, mesh), "backend": dist.get_backend()}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def dryrun_multigpu(n: int, timeout: float = 600.0) -> dict:
    """Run the legs on n gloo ranks → rank 0's results; raises where a rank
    fails or the deadline passes."""
    import torch.multiprocessing as mp

    from ..parallel import free_port

    with tempfile.TemporaryDirectory(prefix="clibd_dryrun_multigpu_") as out_dir:
        ctx = mp.start_processes(_rank_main, args=(n, free_port(), out_dir), nprocs=n,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    losses = {round(r["step"]["loss"], 6) for r in results}
    assert len(losses) == 1, f"ranks disagree on the step's loss: {losses}"
    return results[0]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=4, help="gloo ranks (default 4)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    r = dryrun_multigpu(args.n, args.timeout)
    print(f"dryrun_multigpu({args.n}): {r['backend']} ranks; multi-rank step loss "
          f"{r['step']['loss']:.6f} == global-batch path {r['step']['global_loss']:.6f}, "
          f"{r['step']['grads_checked']} gradients agree; sharded_clip_loss == clip_loss "
          f"({r['loss']['sharded']:.4f}); sharded kNN (query- and key-axis) == one device; "
          f"{args.n}-rank index shards disjoint ({r['shards']['covered']}/"
          f"{r['shards']['records']} covered, drop_last); extract_split_multihost of "
          f"{r['extract']['rows']} rows == extract_split, eval overall "
          f"{r['extract']['overall_acc']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
