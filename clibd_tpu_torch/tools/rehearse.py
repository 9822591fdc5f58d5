"""Full-width accuracy rehearsal on one card: the port of the repository's
`tools/rehearse_tpu.py`.

    python3 -m clibd_tpu_torch.tools.rehearse [epochs] [batch] [--device cpu]

(defaults: 8 epochs, batch 32)

Trains the flagship's dimensions (`ExperimentConfig()`: ViT-B/16 and
BarcodeBERT, LoRA rank 4, no text tower) through the port's `Trainer` on a
synthetic learnable dataset, where a record's species decides both its
image's colour and its barcode's motif, with the main path's kernels on
(the attention forward and backward, fast math, uint8 transport), and
prints the loss of the first and last epoch and the retrieval overall_acc
before and after training: the stack must learn.  The optimiser: lr 1e-4,
no scheduler, no batch scaling.

The data: 128 records a split (no_split_and_seen_train, val_seen,
val_unseen, all_keys) over 8 species, drawn as the JAX package's
`tests/test_learnability.py::make_learnable_hdf5` draws them from the same
seed (48 x 48 JPEGs of a colour per species plus noise; a 60-base motif
ten times and 10 random bases).  `learnable_records` keeps them in memory
in that file's layout and `RecordsSplit` reads them with the HDF5 split
reader's interface, so the port's `BioscanLoader` decodes, crops and
tokenises them as it would the file, and the card needs no h5py.  The
train loader has 2 workers, the eval loaders the pipeline's count; the
command says which JPEG decoder the pipeline took.

On the card it prints the card's name and power limit; `--device cpu`
runs it on the CPU, only when asked.
"""

from __future__ import annotations

import argparse
import io
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.hdf5 import BioscanSplit

SPLITS = ("no_split_and_seen_train", "val_seen", "val_unseen", "all_keys")
EVAL_SPLITS = {"keys": "all_keys", "seen": "val_seen", "unseen": "val_unseen"}
N_PER_SPLIT, N_SPECIES = 128, 8


def learnable_records(n_per_split: int = N_PER_SPLIT, n_species: int = N_SPECIES,
                      seed: int = 0) -> dict:
    """{split: {dataset: array}} in `make_learnable_hdf5`'s layout and draw
    order (the JAX package's tests/test_learnability.py:16-52)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    colors = rng.integers(40, 220, size=(n_species, 3))
    motifs = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(n_species)]
    out = {}
    for split in SPLITS:
        g = {}
        jpegs, species_ids = [], rng.integers(0, n_species, n_per_split)
        for s in species_ids:
            arr = np.clip(colors[s][None, None, :] + rng.normal(0, 18, (48, 48, 3)), 0,
                          255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=90)
            jpegs.append(buf.getvalue())
        maxlen = max(len(j) for j in jpegs)
        img = np.zeros((n_per_split, maxlen), np.uint8)
        mask = np.zeros(n_per_split, np.int64)
        for i, j in enumerate(jpegs):
            img[i, : len(j)] = np.frombuffer(j, np.uint8)
            mask[i] = len(j)
        g["image"], g["image_mask"] = img, mask
        barcodes = [motifs[s] * 10 + "".join(rng.choice(list("ACGT"), 10)) for s in species_ids]
        g["barcode"] = np.array([b.encode() for b in barcodes])
        for level, fmt in (("order", "o{}"), ("family", "f{}"), ("genus", "g{}"),
                           ("species", "sp{}")):
            g[level] = np.array([fmt.format(s).encode() for s in species_ids])
        ids = np.array([f"{split}_{i}".encode() for i in range(n_per_split)])
        g["sampleid"] = g["processid"] = g["image_file"] = ids
        toks = np.ones((n_per_split, 20), np.int64)
        g["language_tokens_input_ids"] = toks
        g["language_tokens_token_type_ids"] = np.zeros_like(toks)
        g["language_tokens_attention_mask"] = toks
        out[split] = g
    return out


class RecordsSplit(BioscanSplit):
    """`BioscanSplit` over one split of `learnable_records` in memory: the
    reader's bulk reads index these arrays as they would the HDF5 datasets."""

    def __init__(self, records: dict, split: str):
        super().__init__(path=None, split=split)
        self._records = records[split]

    @property
    def group(self) -> dict:
        return self._records

    def close(self):
        pass


def rehearsal_config(epochs: int, batch: int):
    """`rehearse_tpu.py`'s GlobalConfig: the flagship defaults, no text, no
    checkpoints, lr 1e-4 without scheduler or batch scaling, evaluated
    before and after by the caller."""
    from ..config.schema import GlobalConfig

    g = GlobalConfig()
    g.save_ckpt = False
    cfg = g.model_config
    cfg.batch_size = batch
    cfg.epochs = epochs
    cfg.evaluation_period = 10_000
    cfg.language.enable = False
    cfg.optim.lr_config.lr = 1e-4
    cfg.optim.scale_lr_by_batch = False
    cfg.optim.lr_scheduler = "none"
    return g


def make_loaders(records: dict, g, train_workers: int = 2):
    """The Trainer's train loader and eval factory, as `Trainer` builds them
    over the HDF5 file, reading `records` instead."""
    from ..data.pipeline import BatchSpec, BioscanLoader

    cfg = g.model_config
    spec = BatchSpec(batch_size=cfg.batch_size, train=True, transport_uint8=cfg.amp,
                     with_image=cfg.image.enable, with_dna=cfg.dna.enable,
                     with_language=cfg.language.enable, dna_kmer=cfg.dna.kmer,
                     dna_tokenizer=cfg.dna.tokenizer, dna_stride=cfg.dna.stride,
                     dna_max_bp=cfg.dna.max_bp)
    train = BioscanLoader(RecordsSplit(records, SPLITS[0]), SPLITS[0], spec,
                          num_workers=train_workers, prefetch=g.pipeline.prefetch_batches,
                          seed=cfg.default_seed, use_native=g.pipeline.use_native_decoder)

    def eval_factory(split, train=False):
        return BioscanLoader(RecordsSplit(records, split), split, BatchSpec.eval_spec(cfg),
                             num_workers=g.pipeline.num_workers,
                             use_native=g.pipeline.use_native_decoder)

    return train, eval_factory


def decoder_name(loader) -> str:
    return "native libjpeg pool" if loader.decoder is not None else "PIL (Python)"


def run(epochs: int = 8, batch: int = 32, device: torch.device | str = "cuda",
        configure: Optional[Callable] = None, records: Optional[dict] = None) -> dict:
    """Evaluate, train `epochs` epochs, evaluate again → {acc_before,
    acc_after, losses, seconds, decoder, fit_evals, steps_per_epoch}.  configure(g): edits the config
    before the model is made (a test narrows the widths)."""
    from ..engine.evaluate import compute_overall_acc
    from ..engine.train import Trainer

    g = rehearsal_config(epochs, batch)
    if configure is not None:
        configure(g)
    records = learnable_records() if records is None else records
    train, eval_factory = make_loaders(records, g)
    print(f"decoder: {decoder_name(train)}", flush=True)
    with tempfile.TemporaryDirectory(prefix="rehearse_") as out_dir:
        trainer = Trainer(g, None, out_dir, train_loader=train, eval_loader_factory=eval_factory,
                          eval_splits=dict(EVAL_SPLITS), device=device)
        try:
            acc0 = compute_overall_acc(trainer.evaluate())
            print(f"before: overall_acc={acc0:.3f}", flush=True)
            t0 = time.time()
            hist = trainer.fit()
            seconds = time.time() - t0
            acc1 = compute_overall_acc(trainer.evaluate())
        finally:
            trainer.close()
    print(f"loss: {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} over {epochs} epochs "
          f"({seconds:.0f}s)", flush=True)
    print(f"after: overall_acc={acc1:.3f}  (before {acc0:.3f})", flush=True)
    return {"acc_before": acc0, "acc_after": acc1, "losses": hist["loss"], "seconds": seconds,
            "decoder": decoder_name(train), "fit_evals": len(hist["overall_acc"]),
            "steps_per_epoch": len(train)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("epochs", nargs="?", type=int, default=8)
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.profiling import require_card

    require_card("rehearse", args.device)
    return run(args.epochs, args.batch, args.device)


if __name__ == "__main__":
    main()
