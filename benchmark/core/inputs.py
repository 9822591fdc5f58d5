"""Host batches made from the seed: the benchmark's copy of what the
program's synthetic split draws (`clibd_tpu_torch/data/synthetic.py`), so
the program receives only generated inputs.

A batch of B rows holds, for the modalities a traffic mix asks for:
- "image": uint8 [B, S, S, 3], uniform bytes; S is `clip.image_size` for a
  configuration of the open_clip backbone (`clip` widths), else the ViT's;
- "dna": k-mer ids of random barcodes.  Non-overlapping k-mers ("kmer"):
  int32 [B, 1 + max_bp // k], id 0 first, then 3 + the k-mer's base-4 value,
  2 (UNK) for a k-mer that runs past the barcode.  Overlapping ("overlap"):
  {"input_ids": int32 [B, (max_bp - k) // stride + 1], 2 + the k-mer's
  value, 1 (UNK) past the barcode; "attention_mask": int32, 1 for the first
  len // stride positions, cut to the ids' width};
- "language": {"input_ids", "token_type_ids", "attention_mask"}: int32
  [B, max_len], ids uniform in [1, vocab) on the first `len` positions and 0
  after, token types 0.  With `clip` widths, CLIP-form text as the synthetic
  split lays it out for the open_clip backbone, the one key its text tower
  reads: {"input_ids": int32 [B, context_length]}, SOT = vocab - 2 first,
  ids uniform in [1, vocab - 3] after it, EOT = vocab - 1 at the row's last
  token (so the row's argmax), 0 after;
- "label": int64 [B], the rows' instance labels (every row its own).

Every batch of every seed has the same multiset of sizes, which sets the
work: barcode lengths 400..659 bp spread evenly over the rows and text
lengths 3..max_len (3..context_length) likewise; the seed draws their order
and the contents.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

BARCODE_BP = (400, 660)  # barcode lengths, lo inclusive, hi exclusive


def even_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """n lengths spread evenly over lo..hi-1 (hi exclusive)."""
    return lo + (np.arange(n) * (hi - lo)) // max(n, 1)


def kmer_ids(bases: np.ndarray, k: int) -> np.ndarray:
    """bases [B, max_bp] in 0..3, 4 past the barcode → non-overlapping k-mer
    ids [B, 1 + max_bp // k]."""
    B, max_bp = bases.shape
    n = max_bp // k
    usable = bases[:, :n * k].reshape(B, n, k).astype(np.int32)
    powers = (4 ** np.arange(k - 1, -1, -1)).astype(np.int32)
    ids = np.where((usable >= 4).any(axis=-1), 2, 3 + (usable * powers).sum(axis=-1))
    return np.concatenate([np.zeros((B, 1), np.int32), ids.astype(np.int32)], axis=1)


def overlap_ids(bases: np.ndarray, lengths: np.ndarray, k: int, stride: int) -> dict:
    """bases [B, max_bp] → overlapping k-mer ids and their key mask."""
    B, max_bp = bases.shape
    n = (max_bp - k) // stride + 1
    idx = np.arange(n)[:, None] * stride + np.arange(k)[None, :]
    windows = bases[:, idx].astype(np.int32)
    powers = (4 ** np.arange(k - 1, -1, -1)).astype(np.int32)
    ids = np.where((windows >= 4).any(axis=-1), 1, 2 + (windows * powers).sum(axis=-1))
    mask = (np.arange(max_bp // stride)[None, :] < (lengths[:, None] // stride)).astype(np.int32)
    return {"input_ids": ids.astype(np.int32), "attention_mask": mask[:, :n]}


def clip_text_ids(rng: np.random.Generator, rows: int, n: int, vocab: int) -> np.ndarray:
    """CLIP-form text ids [rows, n]: SOT, body, EOT at the row's last token,
    zeros after (`data/synthetic.py`'s rule for the open_clip backbone)."""
    lengths = rng.permutation(even_lengths(rows, 3, n + 1))
    mask = (np.arange(n)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, vocab - 2, (rows, n)).astype(np.int32) * mask
    ids[:, 0] = vocab - 2
    ids[np.arange(rows), lengths - 1] = vocab - 1
    return ids


def make_batch(rng: np.random.Generator, widths: dict, rows: int, modalities: Sequence[str],
               first_label: int) -> Dict[str, object]:
    batch: Dict[str, object] = {}
    clip = widths.get("clip")
    if "image" in modalities:
        s = (clip or widths["image"])["image_size"]
        batch["image"] = rng.integers(0, 256, (rows, s, s, 3), dtype=np.uint8)
    if "dna" in modalities:
        d = widths["dna"]
        lengths = rng.permutation(even_lengths(rows, *BARCODE_BP))
        bases = rng.integers(0, 4, (rows, d["max_bp"]), dtype=np.uint8)
        bases[np.arange(d["max_bp"])[None, :] >= lengths[:, None]] = 4
        if d["tokenizer"] == "kmer":
            batch["dna"] = kmer_ids(bases, d["kmer"])
        elif d["tokenizer"] == "overlap":
            batch["dna"] = overlap_ids(bases, lengths, d["kmer"], d["stride"])
        else:
            raise ValueError(f"DNA tokenizer {d['tokenizer']!r}")
    if "language" in modalities and clip:
        batch["language"] = {"input_ids": clip_text_ids(rng, rows, clip["context_length"],
                                                        clip["vocab_size"])}
    elif "language" in modalities:
        t = widths["language"]
        n = t["max_len"]
        lengths = rng.permutation(even_lengths(rows, 3, n + 1))
        mask = (np.arange(n)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(1, t["vocab_size"], (rows, n)).astype(np.int32) * mask
        batch["language"] = {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                             "attention_mask": mask}
    batch["label"] = np.arange(first_label, first_label + rows, dtype=np.int64)
    return batch


def make_pool(widths: dict, seed: int, batches: int, rows: int, modalities: Sequence[str],
              rank: int = 0, ranks: int = 1) -> List[dict]:
    """`batches` distinct host batches of `rows` rows, from the seed.  With
    several ranks, rank r's share of each global batch of rows · ranks,
    from its own stream of the seed; the labels stay distinct over the
    ranks."""
    rng = np.random.default_rng(seed if ranks == 1 else [seed, rank])
    return [make_batch(rng, widths, rows, modalities, (i * ranks + rank) * rows)
            for i in range(batches)]


def take_rows(batch, lo: int, hi: int):
    """Rows lo:hi of every array of a (nested) batch."""
    if isinstance(batch, dict):
        return {k: take_rows(v, lo, hi) for k, v in batch.items()}
    return batch[lo:hi]
