"""A split made in memory from a seed, for driving extraction and training
without a dataset file.

`SyntheticSplit` has the loader interface that `engine.extract.extract_split`
and `engine.train.Trainer` consume from `BioscanLoader`:
`batches(epoch, shuffle, start_batch)`, `len()` (batches per epoch),
`label_dicts()`, `ids()`, `close()` and `spec.batch_size` (the config's batch
size).  Its batches have the shapes and dtypes the model's config asks for:
uint8 images `[B, S, S, 3]` (S the ViT's size, or the CLIP tower's for
`backbone: open_clip`), DNA as k-mer ids from random barcodes of 400 to 659
bp through the real tokenizer (for `dna.tokenizer: overlap`, the overlapping
tokenizer's `{input_ids, attention_mask}`, the mask cut to the ids' width as
the data pipeline cuts it), text as BERT ids with ragged attention masks
(or, for `backbone: open_clip`, CLIP-style ids `[B, context_length]`: SOT,
ids below SOT, EOT = the row's largest id, zero padding, as the BPE
tokenizer lays them out, so no BPE file is needed), and the training label,
the row index (as `BioscanLoader` labels by default, instance
discrimination).  Every epoch yields the same batches in the same
order.  The last batch is ragged when `n` is not a multiple of the batch
size.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .tokenizers import tokenize_dna_batch, tokenize_dna_batch_overlapping


class SyntheticSplit:
    def __init__(self, name: str, n: int, mc, seed: int):
        rng = np.random.default_rng(seed)
        batch_size = mc.batch_size
        self.spec = SimpleNamespace(batch_size=batch_size)
        self.name = name
        clip = mc.backbone == "open_clip"
        size = mc.clip.image_size if clip else mc.image.vit.image_size
        bases = np.frombuffer(b"ACGT", np.uint8)
        barcodes = [bases[rng.integers(0, 4, int(rng.integers(400, 660)))].tobytes()
                    for _ in range(n)]
        if mc.dna.tokenizer == "overlap":
            ids, att = tokenize_dna_batch_overlapping(barcodes, k=mc.dna.kmer,
                                                      stride=mc.dna.stride, max_bp=mc.dna.max_bp)
            dna = {"input_ids": ids, "attention_mask": att[:, :ids.shape[1]]}
        else:
            dna = np.asarray(tokenize_dna_batch(barcodes, k=mc.dna.kmer, max_bp=mc.dna.max_bp),
                             np.int32)
        text_len = mc.clip.context_length if clip else mc.language.max_len
        lengths = rng.integers(3, text_len + 1, n)
        vocab = mc.clip.vocab_size if clip else mc.language.bert.vocab_size
        self._batches = []
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            att = (np.arange(text_len)[None, :] < lengths[lo:hi, None]).astype(np.int32)
            if clip:  # SOT = vocab - 2, EOT = vocab - 1, as in CLIP's BPE vocabulary
                ids = rng.integers(1, vocab - 2, (hi - lo, text_len)).astype(np.int32) * att
                ids[:, 0] = vocab - 2
                ids[np.arange(hi - lo), lengths[lo:hi] - 1] = vocab - 1
                language = {"input_ids": ids}
            else:
                ids = rng.integers(1, vocab, (hi - lo, text_len)).astype(np.int32) * att
                language = {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                            "attention_mask": att}
            self._batches.append({
                "index": np.arange(lo, hi),
                "label": np.arange(lo, hi, dtype=np.int64),
                "image": rng.integers(0, 256, (hi - lo, size, size, 3), dtype=np.uint8),
                "dna": ({k: v[lo:hi] for k, v in dna.items()} if isinstance(dna, dict)
                        else dna[lo:hi]),
                "language": language,
            })
        species = rng.integers(0, 40, n)
        self._labels = [{"order": f"order_{s % 3}", "family": f"family_{s % 7}",
                         "genus": f"genus_{s % 13}", "species": f"species_{s}"} for s in species]
        self._ids = [f"{name}_{i}" for i in range(n)]

    def batches(self, epoch: int = 0, shuffle: bool = False, start_batch: int = 0):
        return iter(self._batches[start_batch:])

    def label_dicts(self):
        return self._labels

    def ids(self):
        return self._ids

    def __len__(self):
        return len(self._batches)

    def close(self):
        pass
