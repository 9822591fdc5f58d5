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
tokenizer lays them out, so no BPE file is needed); a modality whose
`input_type` reads pre-extracted features gets standard-normal fp32 rows of
its `input_dim` instead, as `BioscanLoader` reads `image_features` /
`dna_features`; and the training label,
the row index (as `BioscanLoader` labels by default, instance
discrimination).  Every epoch yields the same batches in the same
order.  The last batch is ragged when `n` is not a multiple of the batch
size.

By default a row's content and its taxonomy label are drawn independently,
so kNN retrieval over such splits is chance and its top-1 decided by
near-ties.  `species=k` draws specimens of k species instead: each species
has a prototype image, barcode, taxonomy text (and feature rows), drawn
from `PROTOTYPE_SEED` so that every split with the same k shares them, and
a specimen is its species' prototype with pixel noise of up to
±`IMAGE_NOISE`, a share `BARCODE_MUTATION` of its bases redrawn (features:
`FEATURE_NOISE` standard deviations), and the species' own text, as
specimens of one species resemble each other in BIOSCAN.

`species_range=(lo, hi)` draws a split's specimens from species lo..hi-1
of the k only (splits of disjoint ranges have disjoint species, as the seen
and unseen splits of BIOSCAN have), and `cover_species=True` gives each
species of the range one of the first rows, so that every one of them has a
label in the split.  For `backbone: open_clip` a species' text is CLIP-style
ids, as above.

`batch_size` overrides the config's batch size, and `modalities` names the
inputs a batch carries (a loader's `with_image` / `with_dna` /
`with_language`).

`two_view=True` gives each batch the second view that
`BatchSpec(two_view=True)` adds for SimCLR, "image2": the same rows' images
with fresh pixel noise of up to ±`IMAGE_NOISE` (the loader's two crops of
one decode), for `engine.simclr.TwoViewLoader(loader=...)`.

`host_id=g, num_hosts=W` keep rank g's share of the split the same
arguments make unsharded, as `BioscanLoader` shards one: the rows that
`data.pipeline.shard_indices(n, 0, g, W, batch_size, shuffle=False,
drop_last=drop_last)` names, in batches of `batch_size`.  With
drop_last=False (the default, an eval loader's) the shards are the strided
rows g::W wrap-padded to equal counts; drop_last=True (a train loader's)
cuts each to whole batches.  `label_dicts()` and `ids()` stay the whole
split's, as `BioscanLoader`'s do.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import numpy as np

from .pipeline import shard_indices
from .tokenizers import tokenize_dna_batch, tokenize_dna_batch_overlapping


PROTOTYPE_SEED = 0
IMAGE_NOISE = 32          # of 255
BARCODE_MUTATION = 0.02
FEATURE_NOISE = 0.1
_BASES = np.frombuffer(b"ACGT", np.uint8)


class _Specimens:
    """Per-species prototypes (`species` of them) and specimens drawn
    around them."""

    def __init__(self, species: int, mc, size: int, text_len: int, vocab: int,
                 clip: bool = False):
        rng = np.random.default_rng(PROTOTYPE_SEED)
        self.images = rng.integers(0, 256, (species, size, size, 3), dtype=np.uint8)
        self.barcodes = [_BASES[rng.integers(0, 4, int(rng.integers(400, 660)))]
                         for _ in range(species)]
        lengths = rng.integers(3, text_len + 1, species)
        self.text_att = (np.arange(text_len)[None, :] < lengths[:, None]).astype(np.int32)
        self.text_ids = rng.integers(1, vocab, (species, text_len)).astype(np.int32) * self.text_att
        if clip:  # SOT, ids below SOT, EOT = the row's largest id
            self.text_ids = np.minimum(self.text_ids, vocab - 3) * self.text_att
            self.text_ids[:, 0] = vocab - 2
            self.text_ids[np.arange(species), lengths - 1] = vocab - 1
        self.image_features = rng.standard_normal((species, mc.image.input_dim), np.float32)
        self.dna_features = rng.standard_normal((species, mc.dna.input_dim), np.float32)

    def barcode(self, rng, s: int) -> bytes:
        b = self.barcodes[s].copy()
        redraw = rng.random(len(b)) < BARCODE_MUTATION
        b[redraw] = _BASES[rng.integers(0, 4, int(redraw.sum()))]
        return b.tobytes()

    def image(self, rng, s: np.ndarray) -> np.ndarray:
        noise = rng.integers(-IMAGE_NOISE, IMAGE_NOISE + 1, (len(s),) + self.images.shape[1:],
                             dtype=np.int16)
        return np.clip(self.images[s].astype(np.int16) + noise, 0, 255).astype(np.uint8)

    def features(self, rng, protos: np.ndarray, s: np.ndarray) -> np.ndarray:
        return protos[s] + FEATURE_NOISE * rng.standard_normal((len(s), protos.shape[1]),
                                                               np.float32)


def _concat(batches: list) -> dict:
    first = batches[0]
    return {k: _concat([b[k] for b in batches]) if isinstance(first[k], dict)
            else np.concatenate([b[k] for b in batches]) for k in first}


def _take(tree: dict, rows: np.ndarray) -> dict:
    return {k: _take(v, rows) if isinstance(v, dict) else v[rows] for k, v in tree.items()}


class SyntheticSplit:
    def __init__(self, name: str, n: int, mc, seed: int, species: Optional[int] = None,
                 two_view: bool = False, species_range: Optional[Tuple[int, int]] = None,
                 cover_species: bool = False, batch_size: Optional[int] = None,
                 modalities: Sequence[str] = ("image", "dna", "language"),
                 host_id: int = 0, num_hosts: int = 1, drop_last: bool = False):
        rng = np.random.default_rng(seed)
        batch_size = batch_size or mc.batch_size
        self.spec = SimpleNamespace(batch_size=batch_size)
        self.name = name
        clip = mc.backbone == "open_clip"
        size = mc.clip.image_size if clip else mc.image.vit.image_size
        text_len = mc.clip.context_length if clip else mc.language.max_len
        vocab = mc.clip.vocab_size if clip else mc.language.bert.vocab_size
        specimens = None
        if species:
            specimens = _Specimens(species, mc, size, text_len, vocab, clip)
            lo, hi = species_range or (0, species)
            if not 0 <= lo < hi <= species or (cover_species and n < hi - lo):
                raise ValueError(f"species_range {species_range} of {species} species, "
                                 f"{n} rows, cover_species={cover_species}")
            row_species = rng.integers(lo, hi, n)
            if cover_species:
                row_species[:hi - lo] = np.arange(lo, hi)
            barcodes = [specimens.barcode(rng, s) for s in row_species]
        else:
            barcodes = [_BASES[rng.integers(0, 4, int(rng.integers(400, 660)))].tobytes()
                        for _ in range(n)]
        if mc.dna.tokenizer == "overlap":
            ids, att = tokenize_dna_batch_overlapping(barcodes, k=mc.dna.kmer,
                                                      stride=mc.dna.stride, max_bp=mc.dna.max_bp)
            dna = {"input_ids": ids, "attention_mask": att[:, :ids.shape[1]]}
        else:
            dna = np.asarray(tokenize_dna_batch(barcodes, k=mc.dna.kmer, max_bp=mc.dna.max_bp),
                             np.int32)
        image_features = not clip and mc.image.input_type != "image"
        dna_features = not clip and mc.dna.input_type != "sequence"
        lengths = None if specimens else rng.integers(3, text_len + 1, n)
        self._batches = []
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            if specimens:
                s = row_species[lo:hi]
                att, ids = specimens.text_att[s], specimens.text_ids[s]
                language = ({"input_ids": ids} if clip else
                            {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                             "attention_mask": att})
                self._batches.append({
                    "index": np.arange(lo, hi),
                    "label": np.arange(lo, hi, dtype=np.int64),
                    "image": (specimens.features(rng, specimens.image_features, s)
                              if image_features else specimens.image(rng, s)),
                    "dna": (specimens.features(rng, specimens.dna_features, s)
                            if dna_features else
                            {k: v[lo:hi] for k, v in dna.items()} if isinstance(dna, dict)
                            else dna[lo:hi]),
                    "language": language,
                })
                continue
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
                "image": (rng.standard_normal((hi - lo, mc.image.input_dim), np.float32)
                          if image_features else
                          rng.integers(0, 256, (hi - lo, size, size, 3), dtype=np.uint8)),
                "dna": (rng.standard_normal((hi - lo, mc.dna.input_dim), np.float32)
                        if dna_features else
                        {k: v[lo:hi] for k, v in dna.items()} if isinstance(dna, dict)
                        else dna[lo:hi]),
                "language": language,
            })
        if two_view:
            if image_features:
                raise ValueError("two_view= needs image input, not image features")
            for batch in self._batches:
                image = batch["image"]
                noise = rng.integers(-IMAGE_NOISE, IMAGE_NOISE + 1, image.shape, dtype=np.int16)
                batch["image2"] = np.clip(image + noise, 0, 255).astype(np.uint8)
        for batch in self._batches:
            for m in {"image", "dna", "language"} - set(modalities):
                del batch[m]
        if num_hosts > 1 or drop_last:
            rows = shard_indices(n, 0, host_id, num_hosts, batch_size, shuffle=False,
                                 drop_last=drop_last)
            whole = _concat(self._batches)
            self._batches = [_take(whole, rows[lo:lo + batch_size])
                             for lo in range(0, len(rows), batch_size)]
        labels = row_species if specimens else rng.integers(0, 40, n)
        self._labels = [{"order": f"order_{s % 3}", "family": f"family_{s % 7}",
                         "genus": f"genus_{s % 13}", "species": f"species_{s}"} for s in labels]
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
