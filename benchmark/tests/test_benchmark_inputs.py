"""Each traffic mix's input maker at test sizes on the CPU: shapes, ranges,
the same sizes for every seed, and k-mer ids as the program's tokenizers
give them."""

import numpy as np
import pytest

from benchmark.core import inputs
from benchmark.core.cell import BENCH, Cell, load_json

SPEC = load_json(BENCH.parent / "BENCHMARK.json")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_pool_of_each_cell(name):
    cell = Cell(name, SPEC)
    w, t = cell.widths, cell.traffic
    a = inputs.make_pool(w, 11, 2, 16, t["modalities"])
    b = inputs.make_pool(w, 2 ** 31 + 5, 2, 16, t["modalities"])
    assert len(a) == 2
    img = a[0]["image"]
    assert img.dtype == np.uint8 and img.shape == (16, 224, 224, 3)
    dna = a[0]["dna"]
    ids = dna["input_ids"] if isinstance(dna, dict) else dna
    assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < w["dna"]["vocab_size"]
    if isinstance(dna, dict):
        assert ids.shape == (16, 657) and dna["attention_mask"].shape == ids.shape
        assert sorted(dna["attention_mask"].sum(1)) == sorted(b[0]["dna"]["attention_mask"].sum(1))
    else:
        assert ids.shape == (16, 133)
        assert sorted((ids == 2).sum(1)) == sorted((b[0]["dna"] == 2).sum(1))
    lang = a[0]["language"]
    assert lang["input_ids"].max() < w["language"]["vocab_size"]
    assert lang["input_ids"].shape == (16, w["language"]["max_len"])
    lengths = lang["attention_mask"].sum(1)
    assert sorted(lengths) == sorted(b[0]["language"]["attention_mask"].sum(1))
    assert 3 <= lang["attention_mask"].sum(1).min() and lang["attention_mask"].sum(1).max() <= 20
    assert len(np.unique(np.concatenate([p["label"] for p in a]))) == 32
    assert not np.array_equal(a[0]["image"], a[1]["image"])
    again = inputs.make_pool(w, 11, 2, 16, t["modalities"])
    assert np.array_equal(again[1]["image"], a[1]["image"])


def _barcodes(rng, n, max_bp):
    lengths = rng.integers(400, 660, n)
    bases = rng.integers(0, 4, (n, max_bp)).astype(np.uint8)
    bases[np.arange(max_bp)[None, :] >= lengths[:, None]] = 4
    strings = [bytes(np.frombuffer(b"ACGT", np.uint8)[row[:l]]) for row, l in zip(bases, lengths)]
    return bases, lengths, strings


def test_kmer_ids_are_the_programs():
    from clibd_tpu_torch.data.tokenizers import tokenize_dna_batch

    bases, _, strings = _barcodes(np.random.default_rng(1), 12, 660)
    assert np.array_equal(inputs.kmer_ids(bases, 5), tokenize_dna_batch(strings, k=5, max_bp=660))


def test_overlap_ids_are_the_programs():
    from clibd_tpu_torch.data.tokenizers import tokenize_dna_batch_overlapping

    bases, lengths, strings = _barcodes(np.random.default_rng(2), 12, 660)
    ids, att = tokenize_dna_batch_overlapping(strings, k=4, stride=1, max_bp=660)
    got = inputs.overlap_ids(bases, lengths, 4, 1)
    assert np.array_equal(got["input_ids"], ids)
    assert np.array_equal(got["attention_mask"], att[:, :ids.shape[1]])
