"""The port's data commands against clibd_tpu's on the CPU, each run through
both command lines on the same inputs: `create-splits` (seeded),
`build-hdf5` (serial, `--parallel` with one and with two reading processes,
and `--parallel --resume` after a cut), `subset-hdf5` (`--ratio` and `--sizes`),
`generate-split-csv` and `fetch-taxonomy` (against a stubbed fetcher: no
request leaves the process).  Every HDF5 dataset and attribute is equal, and
the TSV, CSV and JSON files are byte-identical."""

import io
import json
import urllib.request

import h5py
import numpy as np
import pandas as pd
import pytest

import clibd_tpu.data.builders_5m as jax_builders_5m
import clibd_tpu_torch.data.builders_5m as port_builders_5m
from clibd_tpu.cli import main as jax_main
from clibd_tpu_torch import cli as port_cli

from tests.fixtures import random_barcode, random_jpeg_bytes

MAINS = (("jax", jax_main), ("port", port_cli.main))


def h5_contents(path) -> dict:
    """{name: (array or None, attrs)} of every group and dataset."""
    out = {}
    with h5py.File(path) as f:
        def visit(name, obj):
            data = obj[()] if isinstance(obj, h5py.Dataset) else None
            out[name] = (data, {k: np.asarray(v).tolist() for k, v in obj.attrs.items()})

        f.visititems(visit)
        out["/"] = (None, {k: np.asarray(v).tolist() for k, v in f.attrs.items()})
    return out


def assert_same_hdf5(a, b):
    ca, cb = h5_contents(a), h5_contents(b)
    assert sorted(ca) == sorted(cb) and len(ca) > 1
    for name, (data, attrs) in ca.items():
        other, other_attrs = cb[name]
        assert attrs == other_attrs, name
        if data is None:
            assert other is None, name
        else:
            assert data.dtype == other.dtype and np.array_equal(data, other), name


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A metadata TSV over 48 JPEGs on disk, a split TSV from create-splits
    and a vocab.txt."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(41)
    (root / "imgs").mkdir()
    rows = []
    for i in range(48):
        name = f"i{i}.jpg"
        (root / "imgs" / name).write_bytes(random_jpeg_bytes(rng, h=40, w=48))
        rows.append({"sampleid": f"s{i}", "processid": f"p{i}", "uri": f"u{i % 7}",
                     "image_file": name, "barcode": random_barcode(rng, 90),
                     "order": ["Diptera", "Hymenoptera"][i % 2], "family": f"F{i % 3}",
                     "genus": f"G{i % 4}", "species": f"sp{i % 4}"})
    pd.DataFrame(rows).to_csv(root / "meta.tsv", sep="\t", index=False)
    # two splits of their own: the parallel builder starts a pool of
    # processes per chunk of a split
    for i, row in enumerate(rows):
        row["split"] = "all_keys" if i % 3 else "test_seen"
    pd.DataFrame(rows).to_csv(root / "meta_split.tsv", sep="\t", index=False)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "diptera", "hymenoptera", "f0", "f1",
             "f2", "g0", "g1", "g2", "g3", "sp0", "sp1", "sp2", "sp3"]
    (root / "vocab.txt").write_text("\n".join(words) + "\n")
    return root


def run(main, *argv):
    assert main(list(argv)) == 0


def test_create_splits_writes_what_jax_writes(raw, tmp_path):
    for name, main in MAINS:
        run(main, "create-splits", "--metadata", str(raw / "meta.tsv"),
            "--out", str(tmp_path / f"{name}.tsv"), "--min-species-size", "5", "--seed", "3")
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


@pytest.fixture(scope="module")
def splits(raw, tmp_path_factory):
    path = tmp_path_factory.mktemp("splits") / "splits.tsv"
    run(port_cli.main, "create-splits", "--metadata", str(raw / "meta.tsv"), "--out", str(path),
        "--min-species-size", "5", "--seed", "3")
    return path


def _build(main, raw, splits, out, *extra):
    run(main, "build-hdf5", "--metadata", str(raw / "meta.tsv"), "--splits", str(splits),
        "--image-dir", str(raw / "imgs"), "--out", str(out), "--vocab", str(raw / "vocab.txt"),
        *extra)


@pytest.mark.parametrize("mode", [[], ["--compress"], ["--parallel", "--processes", "1",
                                                            "--chunk-size", "8"]])
def test_build_hdf5_writes_what_jax_writes(raw, splits, tmp_path, mode):
    for name, main in MAINS:
        _build(main, raw, splits, tmp_path / f"{name}.hdf5", *mode)
    assert_same_hdf5(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")


def test_build_hdf5_parallel_with_two_processes(raw, tmp_path):
    """`--parallel --processes 2` (a pool of reading processes) over a
    metadata TSV with its own two splits."""
    for name, main in MAINS:
        run(main, "build-hdf5", "--metadata", str(raw / "meta_split.tsv"), "--image-dir",
            str(raw / "imgs"), "--out", str(tmp_path / f"{name}.hdf5"), "--parallel",
            "--processes", "2", "--chunk-size", "64")
    assert_same_hdf5(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    with h5py.File(tmp_path / "port.hdf5") as f:
        assert sorted(f) == ["all_keys", "test_seen"] and len(f["all_keys"]["image"]) == 32


class Cut(Exception):
    pass


def test_build_hdf5_resume_after_a_cut(raw, splits, tmp_path, monkeypatch):
    """A `--parallel` build cut after its first chunk, then `--parallel
    --resume`, in each package: the two files equal each other and an
    uncut build.  One reading process (the builder's thread pool): a pool of
    processes starts once per chunk, and is held by the test above."""
    for name, main, mod in (("jax", jax_main, jax_builders_5m),
                            ("port", port_cli.main, port_builders_5m)):
        append = mod.ChunkedSplitWriter.append
        calls = {"n": 0}

        def cut_append(self, records, jpegs, append=append, calls=calls):
            if calls["n"] == 1:
                raise Cut("cut after the first chunk")
            calls["n"] += 1
            return append(self, records, jpegs)

        monkeypatch.setattr(mod.ChunkedSplitWriter, "append", cut_append)
        with pytest.raises(Cut):
            _build(main, raw, splits, tmp_path / f"{name}.hdf5", "--parallel", "--processes",
                   "1", "--chunk-size", "8")
        monkeypatch.setattr(mod.ChunkedSplitWriter, "append", append)
        _build(main, raw, splits, tmp_path / f"{name}.hdf5", "--parallel", "--processes", "1",
               "--chunk-size", "8", "--resume")
    _build(port_cli.main, raw, splits, tmp_path / "uncut.hdf5", "--parallel", "--processes",
           "1", "--chunk-size", "8")
    assert_same_hdf5(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    with h5py.File(tmp_path / "port.hdf5") as f, h5py.File(tmp_path / "uncut.hdf5") as g:
        assert set(f) == set(g)
        for split in f:
            assert np.array_equal(f[split]["sampleid"][()], g[split]["sampleid"][()])
            assert np.array_equal(f[split]["image"][()], g[split]["image"][()])


@pytest.mark.parametrize("how", [["--ratio", "0.5", "--split", "all_keys"],
                                 ["--ratio", "0.3", "--split", "all_keys", "--no-other-splits",
                                  "--seed", "7"],
                                 ["--sizes", "all_keys=5", "test_seen=3"]])
def test_subset_hdf5_writes_what_jax_writes(tiny_hdf5, tmp_path, how):
    for name, main in MAINS:
        run(main, "subset-hdf5", "--hdf5", tiny_hdf5, "--out", str(tmp_path / f"{name}.hdf5"),
            *how)
    assert_same_hdf5(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")


@pytest.mark.parametrize("splits_list", [[], ["--splits-list", "test_seen", "all_keys"]])
def test_generate_split_csv_writes_what_jax_writes(tiny_hdf5, tmp_path, splits_list):
    for name, main in MAINS:
        run(main, "generate-split-csv", "--hdf5", tiny_hdf5, "--out",
            str(tmp_path / f"{name}.csv"), *splits_list)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert len((tmp_path / "port.csv").read_text().splitlines()) > 1


ESEARCH = b"""<?xml version="1.0"?>
<eSearchResult><Count>1</Count><IdList><Id>27457</Id></IdList></eSearchResult>"""
ESEARCH_EMPTY = b"""<?xml version="1.0"?>
<eSearchResult><Count>0</Count><IdList></IdList></eSearchResult>"""
EFETCH = b"""<?xml version="1.0"?>
<TaxaSet><Taxon><TaxId>27457</TaxId><LineageEx>
  <Taxon><TaxId>2</TaxId><ScientificName>Diptera</ScientificName><Rank>order</Rank></Taxon>
  <Taxon><TaxId>3</TaxId><ScientificName>Sciaridae</ScientificName><Rank>family</Rank></Taxon>
  <Taxon><TaxId>4</TaxId><ScientificName>Bradysia</ScientificName><Rank>genus</Rank></Taxon>
</LineageEx></Taxon></TaxaSet>"""


def test_fetch_taxonomy_writes_what_jax_writes(tmp_path, monkeypatch):
    """`fetch-taxonomy --species ...` against a stub of `urlopen` (the
    default fetcher's only way out) and no rate-limit sleep: the same JSON,
    the unknown species not_classified; a second run resumes from it."""
    urls = []

    def stub_urlopen(url, timeout=None):
        urls.append(url)
        if "esearch" in url:
            return io.BytesIO(ESEARCH_EMPTY if "Unknownus" in url else ESEARCH)
        if "efetch" in url:
            return io.BytesIO(EFETCH)
        raise AssertionError(url)

    monkeypatch.setattr(urllib.request, "urlopen", stub_urlopen)
    monkeypatch.setattr("time.sleep", lambda s: None)
    for name, main in MAINS:
        run(main, "fetch-taxonomy", "--out", str(tmp_path / f"{name}.json"), "--email",
            "a@b.c", "--species", "Bradysia impatiens", "Unknownus speciesus")
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert json.loads(got)["Bradysia impatiens"] == {"genus": "Bradysia", "family": "Sciaridae",
                                                     "order": "Diptera"}
    assert len(urls) == 6  # two lookups and one fetch a package
    run(port_cli.main, "fetch-taxonomy", "--out", str(tmp_path / "port.json"), "--email",
        "a@b.c", "--species", "Bradysia impatiens")
    assert len(urls) == 6 and (tmp_path / "port.json").read_bytes() == got
