"""Train-step throughput of the flagship model on one card: the port of the
repository's `tools/bench_train.py`.

    python3 -m clibd_tpu_torch.tools.bench_train [batch ...] [--policy P ...] [--accum K ...]
        [--device cpu]

(default batches 128 500; default policy: the config's own, "attn")

- batch >= 256: the tri-modal full fine-tune with remat, the released
  recipe's batch (for_bioscan_1m/final_experiments/image_dna_text_seed_42.yaml's
  widths: ViT-B/16, BarcodeBERT, BERT-small);
- batch < 256: image + DNA with LoRA (rank 4) and remat.

--policy sweeps the remat policies per batch: "none" (blanket recompute),
"off" (no remat), or a save-policy spec ("attn", "attn+mlp", "dots", ...;
`models/layers.remat_policy`).  --accum K runs the gradient cache with K
microbatches (`engine/train.make_train_step_accum`).

Each cell: a seeded fresh init, bf16, AdamW at the recipe's schedule,
images [B, 224, 224, 3] in [0, 1) and DNA ids [B, 133] (and text ids
[B, 20]) from `np.random.default_rng(0)`, every step on the same batch and
augmentation seed; 2 warm-up steps, then the best of 3 passes of 8 steps,
each pass closed by a device sync.  A row gives ms a step, samples/s, the
last loss and the peak device memory.  A cell that runs out of device
memory prints `FAILED OOM` and the sweep goes on; any other error stops it.
The command exits non-zero when a default cell (batch 128 or 500 at the
config's policy, no accumulation) ran out of memory.

On the card it prints the card's name and power limit beside the rows;
`--device cpu` runs the same cells on the CPU, only when asked (at these
widths a step takes minutes there).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

DEFAULT_BATCHES = (128, 500)
WARMUP, ITERS, PASSES = 2, 8, 3


def cell_config(batch: int, policy: Optional[str] = None, accum: int = 1):
    """The cell's model config: tri-modal full fine-tune at batch >= 256,
    else image + DNA with LoRA; remat on, `policy` over the config's."""
    from ..config.schema import ExperimentConfig

    cfg = ExperimentConfig()
    cfg.batch_size = batch
    tri_modal = batch >= 256
    cfg.language.enable = tri_modal
    cfg.disable_lora = tri_modal
    cfg.remat = True
    if policy == "off":
        cfg.remat = False
    elif policy is not None:
        cfg.remat_policy = policy
    cfg.accum_steps = accum
    return cfg


def cell_batch(cfg, device) -> dict:
    """The cell's batch on `device`, from `np.random.default_rng(0)`."""
    from ..engine.extract import to_device

    B = cfg.batch_size
    rng = np.random.default_rng(0)
    batch = {"image": rng.random((B, 224, 224, 3), dtype=np.float32),
             "dna": rng.integers(0, 1027, (B, 133)).astype(np.int32),
             "label": np.arange(B, dtype=np.int32)}
    if cfg.language.enable:
        batch["language"] = {"input_ids": rng.integers(0, 30522, (B, 20)).astype(np.int32),
                             "token_type_ids": np.zeros((B, 20), np.int32),
                             "attention_mask": np.ones((B, 20), np.int32)}
    return to_device(batch, torch.device(device))


def attention_layers(cfg) -> int:
    """Layers a train step runs the attention kernels in: every tower's."""
    n = cfg.image.vit.num_layers + cfg.dna.bert.num_layers
    return n + (cfg.language.bert.num_layers if cfg.language.enable else 0)


def forward_launches_per_layer(cfg) -> int:
    """The forward kernel's launches a layer and step: 2 where remat
    recomputes the attention in the backward (blanket remat, or a policy
    that does not save its output, "attn"), else 1."""
    if not cfg.remat:
        return 1
    return 1 if "attn" in str(cfg.remat_policy).split("+") else 2


def attention_launches(cfg) -> tuple:
    """(forward, backward) attention kernel launches of one train step.  The
    gradient cache (accum_steps k > 1) runs every layer's forward once a
    microbatch without grad, then again with grad."""
    layers, k = attention_layers(cfg), cfg.accum_steps
    forward = forward_launches_per_layer(cfg)
    if k > 1:
        return layers * k * (1 + forward), layers * k
    return layers * forward, layers


def describe(cfg) -> str:
    mode = ("tri-modal" if cfg.language.enable else "image+DNA")
    mode += " full-ft" if cfg.disable_lora else f" lora r={cfg.lora_rank}"
    mode += f" remat[{cfg.remat_policy}]" if cfg.remat else " no-remat"
    if cfg.accum_steps > 1:
        mode += f" accum={cfg.accum_steps}"
    return mode


def bench(cfg, device: torch.device | str = "cuda", warmup: int = WARMUP, iters: int = ITERS,
          passes: int = PASSES) -> dict:
    """Time the train step of `cfg` on `device` → {batch, mode, ms, samples_per_s,
    loss, peak_gib, steps}."""
    from ..engine.schedules import build_schedule
    from ..engine.train import build_optimizer, make_train_step_accum
    from ..models.clibd import init_clibd_model
    from ..utils import profiling

    device = torch.device(device)
    model = init_clibd_model(cfg, torch.Generator().manual_seed(0), device)
    optimizer = build_optimizer(cfg, model, build_schedule(cfg.optim, total_steps=1000,
                                                           batch_size=cfg.batch_size))
    step = make_train_step_accum(cfg, model, optimizer, cfg.accum_steps)
    batch = cell_batch(cfg, device)

    losses = []

    def run():
        # the same augmentation seed every step, as the JAX script's fixed key
        losses[:] = [step(batch, torch.Generator(device=device).manual_seed(7))]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dt = profiling.timeit(run, device, warmup, iters, passes)
    (loss,) = losses
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None
    return {"batch": cfg.batch_size, "mode": describe(cfg), "ms": dt * 1e3,
            "samples_per_s": cfg.batch_size / dt, "loss": float(loss), "peak_gib": peak,
            "steps": warmup + passes * iters}


def format_row(r: dict) -> str:
    peak = "" if r["peak_gib"] is None else f"  peak {r['peak_gib']:.2f} GiB"
    return (f"train step batch {r['batch']} ({r['mode']}): {r['ms']:.1f} ms/step  "
            f"{r['samples_per_s']:.1f} samples/s/card  loss={r['loss']:.4f}{peak}")


def sweep(batches, policies, accums, device="cuda", **timing) -> tuple:
    """Every (batch, policy, accum) cell → (rows, failed cells).  Only
    `torch.cuda.OutOfMemoryError` is caught: the cell is reported and the
    sweep goes on."""
    rows, failed = [], []
    for b in batches:
        for p in policies:
            for a in accums:
                try:
                    rows.append(bench(cell_config(b, p, a), device, **timing))
                    print(format_row(rows[-1]), flush=True)
                except torch.cuda.OutOfMemoryError as e:
                    failed.append((b, p, a))
                    print(f"train step batch {b} policy {p} accum {a}: FAILED OOM "
                          f"{str(e)[:200]}", flush=True)
                finally:
                    if torch.device(device).type == "cuda":
                        torch.cuda.empty_cache()
    return rows, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="*", type=int)
    ap.add_argument("--policy", action="append", default=None)
    ap.add_argument("--accum", action="append", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.profiling import require_card

    device = torch.device(args.device)
    require_card("bench_train", device)
    batches = args.batches or list(DEFAULT_BATCHES)
    _, failed = sweep(batches, args.policy or [None], args.accum or [1], device)
    defaults = [f for f in failed if f[0] in DEFAULT_BATCHES and f[1] is None and f[2] == 1]
    return 1 if defaults else 0


if __name__ == "__main__":
    sys.exit(main())
