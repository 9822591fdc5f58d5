"""Sustained training soak at realistic scale, with a hard kill and a resume:
the port of the repository's `tools/soak_train.py`.

    python3 -m clibd_tpu_torch.tools.soak_train build
    python3 -m clibd_tpu_torch.tools.soak_train run --tag base            # one epoch
    python3 -m clibd_tpu_torch.tools.soak_train run --tag killed --kill-at 55
    python3 -m clibd_tpu_torch.tools.soak_train run --tag resumed --resume  # the killed run, on
    python3 -m clibd_tpu_torch.tools.soak_train compare                  # bit for bit
    (each takes --workdir DIR, default <tmp>/clibd_soak_train, and --device cpu)

Drives the flagship's batch-500 tri-modal full fine-tune (ViT-B/16,
BarcodeBERT, BERT-small; remat "attn") through the port's real `Trainer`:
the HDF5 loader, the native JPEG decode where `native/` builds, prefetch,
uint8 transport and the train step on the card, over a synthetic
50,000-record split of unique 256 x 256 JPEGs (the BIOSCAN-1M image shape;
a colour per species, a barcode motif per species) for one epoch (100
steps).  `run` prints one JSON line: the steady wall ms a step (the median
step interval after the first 3), the device-only ms a step measured again
in the process on a batch already on the card, the input-bound share, the
end-to-end samples/s and the epoch's mean loss; every step's loss goes to
<workdir>/soak_<tag>.jsonl.  The kill leg sends itself SIGKILL from the
step log (no atexit, no finally) once step --kill-at is logged; --resume
continues from the step-cadence checkpoint (`checkpoint_every_steps`, 25)
in <workdir>/out/last, and `compare` fails unless every step the resumed
run shares with the base run has the same loss, bit for bit.

`--device cpu` runs the same at a tiny width and size for a rehearsal
(`TINY`: one layer a tower, 32 wide; `TINY_SIZES`: 48 training records in
batches of 8, last/ every 2 steps).  Needs h5py.  On the card it prints the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import signal
import tempfile
import time

import numpy as np

# training records, batch and the step-cadence checkpoint's interval: the
# JAX script's on the card, and the CPU rehearsal's
SIZES = (50_000, 500, 25)
TINY_SIZES = (48, 8, 2)
# the CPU rehearsal's widths: one layer a tower, 32 wide
TINY = ("model_config.output_dim=16", "model_config.image.vit.patch_size=32",
        "model_config.image.vit.hidden_size=32", "model_config.image.vit.num_layers=1",
        "model_config.image.vit.num_heads=2", "model_config.image.vit.mlp_dim=64",
        "model_config.dna.bert.hidden_size=32", "model_config.dna.bert.num_layers=1",
        "model_config.dna.bert.num_heads=2", "model_config.dna.bert.intermediate_size=64",
        "model_config.language.bert.hidden_size=32", "model_config.language.bert.num_layers=1",
        "model_config.language.bert.num_heads=2",
        "model_config.language.bert.intermediate_size=64")


def default_workdir() -> str:
    return os.path.join(tempfile.gettempdir(), "clibd_soak_train")


def on_cpu(device) -> bool:
    return str(device).split(":")[0] == "cpu"


def sizes(device) -> tuple:
    """(training records, batch, checkpoint interval) of a run on `device`."""
    return TINY_SIZES if on_cpu(device) else SIZES


def build(path: str, splits=None, n_species: int = 200, n_train: int = SIZES[0]):
    """A DATA.md-schema HDF5 of unique 256 x 256 JPEGs at scale.  splits:
    ((name, n_records), ...), default the training soak's layout;
    `soak_extract` writes its eval-sized splits with it."""
    import h5py
    from PIL import Image

    rng = np.random.default_rng(0)
    colors = rng.integers(40, 220, size=(n_species, 3))
    motifs = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(n_species)]
    t0 = time.time()
    if splits is None:
        splits = (("no_split_and_seen_train", n_train), ("val_seen", 256), ("val_unseen", 256),
                  ("all_keys", 512))
    total = sum(n for _, n in splits)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        for split, n in splits:
            g = f.create_group(split)
            img_ds = None
            species_all = rng.integers(0, n_species, n)
            mask = np.zeros(n, np.int64)
            chunk = 1000
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                jpegs = []
                for s in species_all[lo:hi]:
                    arr = np.clip(colors[s][None, None, :] + rng.normal(0, 18, (256, 256, 3)),
                                  0, 255).astype(np.uint8)
                    buf = io.BytesIO()
                    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
                    jpegs.append(buf.getvalue())
                m = max(len(j) for j in jpegs)
                if img_ds is None:
                    img_ds = g.create_dataset("image", shape=(n, int(m * 1.5)),
                                              maxshape=(n, None), dtype=np.uint8,
                                              chunks=(min(64, n), int(m * 1.5)))
                if m > img_ds.shape[1]:
                    img_ds.resize((n, m))
                block = np.zeros((hi - lo, img_ds.shape[1]), np.uint8)
                for i, j in enumerate(jpegs):
                    block[i, : len(j)] = np.frombuffer(j, np.uint8)
                    mask[lo + i] = len(j)
                img_ds[lo:hi] = block
                if lo % 10_000 == 0:
                    print(f"{split}: {lo}/{n} ({time.time() - t0:.0f}s)", flush=True)
            g.create_dataset("image_mask", data=mask)
            barcodes = [motifs[s] * 10 + "".join(rng.choice(list("ACGT"), 10))
                        for s in species_all]
            g.create_dataset("barcode", data=np.array([b.encode() for b in barcodes]))
            for level, fmt in (("order", "o{}"), ("family", "f{}"), ("genus", "g{}"),
                               ("species", "sp{}")):
                g.create_dataset(level, data=np.array([fmt.format(s).encode()
                                                       for s in species_all]))
            ids = np.array([f"{split}_{i}".encode() for i in range(n)])
            g.create_dataset("sampleid", data=ids)
            g.create_dataset("processid", data=ids)
            g.create_dataset("image_file", data=ids)
            toks = np.ones((n, 20), np.int64)
            g.create_dataset("language_tokens_input_ids", data=toks)
            g.create_dataset("language_tokens_token_type_ids", data=np.zeros_like(toks))
            g.create_dataset("language_tokens_attention_mask", data=toks)
    print(f"built {path}: {total} records, {os.path.getsize(path) / 1e9:.2f} GB, "
          f"{time.time() - t0:.0f}s", flush=True)


def soak_config(device):
    """The flagship's full fine-tune, one epoch, no eval, last/ at the
    step cadence; `TINY` widths and `TINY_SIZES` on the CPU."""
    from ..config import load_config

    _, batch, checkpoint_every = sizes(device)
    g = load_config(overrides=TINY if on_cpu(device) else ())
    g.save_ckpt = True
    cfg = g.model_config
    cfg.batch_size = batch
    cfg.epochs = 1
    cfg.language.enable = True
    cfg.disable_lora = True
    cfg.evaluation_period = 10_000
    cfg.eval_skip_epoch = 10_000
    cfg.checkpoint_every_steps = checkpoint_every
    return g


def run(workdir: str, tag: str, kill_at: int = 0, resume: bool = False,
        device: str = "cuda", card=None) -> dict:
    import torch

    from ..engine.extract import to_device
    from ..engine.train import Trainer, batch_generator

    g = soak_config(device)
    batch = g.model_config.batch_size
    out_dir = os.path.join(workdir, "out")
    times = []
    with open(os.path.join(workdir, f"soak_{tag}.jsonl"), "a" if resume else "w") as logf:
        def log(d):
            if "loss" in d:
                d = dict(d, t=time.time())
                times.append(d["t"])
                logf.write(json.dumps(d) + "\n")
                logf.flush()
                print(f"step {d['step']:3d} loss {d['loss']:.4f}", flush=True)
                if kill_at and d["step"] >= kill_at:
                    print(f"SIGKILL at step {d['step']}", flush=True)
                    os.kill(os.getpid(), signal.SIGKILL)

        trainer = Trainer(g, os.path.join(workdir, "soak.hdf5"), output_dir=out_dir,
                          eval_splits={"keys": "all_keys", "seen": "val_seen",
                                       "unseen": "val_unseen"},
                          log_fn=log, device=device)
        start_epoch = 0
        if resume:
            start_epoch = trainer.resume(os.path.join(out_dir, "last"))
            print(f"resumed: global_step={trainer.global_step}, start_epoch={start_epoch}, "
                  f"start_batch={trainer._resume_start_batch}", flush=True)
        t0 = time.time()
        hist = trainer.fit(start_epoch=start_epoch)
        wall = time.time() - t0

    # steady wall a step: the median interval after the first 3 steps
    if len(times) > 6:
        wall_step = float(np.median(np.diff(np.asarray(times))[3:]))
    else:
        wall_step = wall / max(len(times), 1)

    # the device-only step, measured again on a batch already on the device
    dev_type = torch.device(device).type
    batch_data = next(iter(trainer.train_loader.batches(epoch=0)))
    model_batch = to_device({k: batch_data[k] for k in ("image", "dna", "language", "label")
                             if k in batch_data}, trainer.device)
    gen = batch_generator(trainer.device, 0, 0, 0)
    trainer.step_fn(model_batch, gen)
    dev = float("inf")
    for _ in range(4):
        t = time.perf_counter()
        loss = trainer.step_fn(model_batch, gen)
        float(loss)  # waits for the device
        dev = min(dev, time.perf_counter() - t)
    trainer.close()
    summary = {"tag": tag, "steps": len(times), "wall_s": round(wall, 1),
               "steady_wall_ms_per_step": round(wall_step * 1e3, 1),
               "device_ms_per_step": round(dev * 1e3, 1),
               "input_bound_frac": round(max(0.0, 1 - dev / wall_step), 3),
               "samples_per_s_endtoend": round(batch / wall_step, 1),
               "loss_epoch_mean": hist["loss"] and round(hist["loss"][-1], 4),
               "device": dev_type, "card": card}
    print(json.dumps(summary), flush=True)
    return summary


def compare(workdir: str) -> dict:
    def load(tag):
        out = {}
        with open(os.path.join(workdir, f"soak_{tag}.jsonl")) as f:
            for line in f:
                d = json.loads(line)
                out[d["step"]] = d["loss"]
        return out

    base, killed, resumed = load("base"), load("killed"), load("resumed")
    overlap = sorted(set(resumed) & set(base))
    if not overlap:
        raise RuntimeError("soak_train compare: no overlapping steps")
    mism = [s for s in overlap if base[s] != resumed[s]]
    print(f"killed run reached step {max(killed)}; resumed covers {min(resumed)}..{max(resumed)}; "
          f"overlap with base: {len(overlap)} steps; mismatches: {len(mism)} {mism[:5]}")
    # a step on identical state, batch and generator is deterministic on one device
    if mism:
        raise RuntimeError("soak_train compare: resume is NOT bit-exact")
    print("RESUME BIT-EXACT: OK", flush=True)
    return {"killed_max": max(killed), "resumed": (min(resumed), max(resumed)),
            "overlap": len(overlap), "mismatches": mism}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["build", "run", "compare"])
    ap.add_argument("--tag", default="base")
    ap.add_argument("--kill-at", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    workdir = a.workdir or default_workdir()
    os.makedirs(workdir, exist_ok=True)
    if a.mode == "build":
        return build(os.path.join(workdir, "soak.hdf5"), n_train=sizes(a.device)[0])
    if a.mode == "compare":
        return compare(workdir)
    from ..utils.profiling import require_card

    card = require_card("soak_train", a.device)
    return run(workdir, a.tag, kill_at=a.kill_at, resume=a.resume, device=a.device, card=card)


if __name__ == "__main__":
    main()
