"""The port's embedding export (clibd_tpu_torch/engine/extract.py:
save_embedding_export, AppendableEmbeddingWriter, stream_extract_split)
against clibd_tpu's writers, and the `extract` / `extract-single`
subcommands end to end on the CPU.  Every input comes from a numpy
generator seeded inside its test."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import jax

from clibd_tpu.data.pipeline import BatchSpec as JaxBatchSpec
from clibd_tpu.data.pipeline import BioscanLoader as JaxLoader
from clibd_tpu.engine import extract as jax_extract
from clibd_tpu.models import layers as jax_layers
from clibd_tpu_torch.data.pipeline import BatchSpec, BioscanLoader
from clibd_tpu_torch.engine import extract as port_extract
from clibd_tpu_torch.models.convert import model_from_jax
from tests.fixtures import random_jpeg_bytes
from tests.torch_tiny import port_tiny_cfg, tiny_cfg

LEVELS = ("order", "family", "genus", "species")
EMB_ATOL = 1e-3  # as tests/test_torch_extract_eval.py: the two packages' fp32 paths


def _read(path):
    with h5py.File(path) as f:
        return {k: (f[k].dtype, f[k][:]) for k in f}


def _assert_same_file(got_path, want_path, atol=0.0):
    got, want = _read(got_path), _read(want_path)
    assert sorted(got) == sorted(want)
    for k, (dtype, values) in want.items():
        assert got[k][0] == dtype, k
        if atol and dtype == np.float32:
            np.testing.assert_allclose(got[k][1], values, rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k][1], values, err_msg=k)


def _split_dict(rng, n, with_language=False):
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    return {"encoded_image_feature": feats, "encoded_dna_feature": feats[::-1].copy(),
            "encoded_language_feature": feats * 2 if with_language else None,
            "label_list": [{lv: f"{lv}{i % 3}" for lv in LEVELS} for i in range(n)],
            "file_name_list": [f"rec{i}" for i in range(n)]}


@pytest.mark.parametrize("compress,with_language", [(True, False), (False, True)])
def test_save_embedding_export_matches_jax(tmp_path, compress, with_language):
    split = _split_dict(np.random.default_rng(1), 9, with_language)
    jax_extract.save_embedding_export(str(tmp_path / "jax.hdf5"), split, compress=compress)
    port_extract.save_embedding_export(str(tmp_path / "port.hdf5"), split, compress=compress)
    _assert_same_file(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    with h5py.File(tmp_path / "port.hdf5") as f:
        assert ("encoded_language_feature" in f) == with_language
        assert (f["encoded_image_feature"].compression == "gzip") == compress


def test_appendable_writer_matches_jax(tmp_path):
    """Batches appended through both writers give the same datasets, dtypes
    and values; a reopened file reports its consistent prefix, and truncate
    cuts every dataset back to it."""
    rng = np.random.default_rng(2)
    batches = [_split_dict(rng, n) for n in (4, 4, 3)]
    for name, mod in (("jax", jax_extract), ("port", port_extract)):
        w = mod.AppendableEmbeddingWriter(str(tmp_path / f"{name}.hdf5"), feature_dim=8)
        for b in batches + [_split_dict(rng, 0)]:
            w.append({k: b[k] for k in ("encoded_image_feature", "encoded_dna_feature")},
                     b["label_list"], b["file_name_list"])
        assert w.n_rows == 11
        w.close()
    _assert_same_file(tmp_path / "port.hdf5", tmp_path / "jax.hdf5")
    with h5py.File(tmp_path / "port.hdf5", "r+") as f:
        f["genus_list"].resize((6,))  # a kill between two datasets' resizes
    w = port_extract.AppendableEmbeddingWriter(str(tmp_path / "port.hdf5"), feature_dim=8,
                                               resume=True)
    assert w.n_rows == 6
    w.truncate(4)
    assert w.n_rows == 4
    w.close()
    got = _read(tmp_path / "port.hdf5")
    assert {v[1].shape[0] for v in got.values()} == {4}
    assert got["file_name"][1][0] == b"rec0"


# appends two batches through the port's writer, then SIGKILLs its own
# process: no close, no atexit, no HDF5 shutdown
_KILLED_WRITER = """
import os, signal, sys
import numpy as np
from clibd_tpu_torch.engine.extract import AppendableEmbeddingWriter
path, rows = sys.argv[1], [int(n) for n in sys.argv[2:]]
rng = np.random.default_rng(5)
w = AppendableEmbeddingWriter(path, feature_dim=8)
for i, n in enumerate(rows):
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    w.append({"encoded_image_feature": feats, "encoded_dna_feature": -feats},
             [{lv: f"{lv}{i}" for lv in ("order", "family", "genus", "species")}] * n,
             [f"b{i}r{j}" for j in range(n)])
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_appendable_writer_rows_survive_a_sigkill(tmp_path):
    """Every append that returned is on disk when the process is killed
    right after it: the file opens, file_name holds every appended row, and
    each dataset's rows up to len(file_name) are the written ones."""
    path, rows = tmp_path / "killed.hdf5", (5, 3)
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _KILLED_WRITER, str(path), *map(str, rows)],
                          cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == -9, proc.stderr[-2000:]
    rng = np.random.default_rng(5)
    feats = np.concatenate([rng.standard_normal((n, 8)).astype(np.float32) for n in rows])
    with h5py.File(path, "r") as f:
        n = f["file_name"].shape[0]
        assert n == sum(rows)
        assert [x.decode() for x in f["file_name"][:n]] == [
            f"b{i}r{j}" for i, k in enumerate(rows) for j in range(k)]
        np.testing.assert_array_equal(f["encoded_image_feature"][:n], feats)
        np.testing.assert_array_equal(f["encoded_dna_feature"][:n], -feats)
        for lv in LEVELS:
            assert [x.decode() for x in f[f"{lv}_list"][:n]] == [
                f"{lv}{i}" for i, k in enumerate(rows) for _ in range(k)]


def _cfgs():
    """The tiny tri-modal config of tests/torch_tiny.py with no LoRA, its text
    vocabulary widened to the fixture HDF5's token ids → (JAX, port)."""
    cfgs = tiny_cfg(disable_lora=True), port_tiny_cfg(disable_lora=True)
    for c in cfgs:
        c.language.bert.vocab_size = 1000
    return cfgs


@pytest.fixture(scope="module")
def tiny_model():
    """One weight set of the tiny model in both packages, with larger qkv
    weights so attention is far from uniform."""
    from clibd_tpu.models import init_clibd_params

    tree = jax.tree.map(np.asarray, init_clibd_params(jax.random.PRNGKey(1), _cfgs()[0]))
    for enc in ("image_encoder", "dna_encoder", "language_encoder"):
        w = tree[enc]["blocks"]["qkv_w"]
        tree[enc]["blocks"]["qkv_w"] = (np.random.default_rng(2).standard_normal(w.shape)
                                        * 0.1).astype(np.float32)
    return tree, model_from_jax(tree, _cfgs()[1], "cpu")


def _port_loader(hdf5, batch_size=5):
    spec = BatchSpec(batch_size=batch_size, image_size=32, resize_to=36, dna_max_bp=80,
                     train=False)
    return BioscanLoader(hdf5, "all_keys", spec, num_workers=0)


def test_stream_extract_matches_jax_stream(tiny_hdf5, tiny_model, tmp_path):
    """The streamed file holds the JAX package's datasets, dtypes, labels
    and ids, and its embeddings to the two packages' fp32 agreement (JAX
    with its Pallas kernel in interpret mode); the ragged last batch too
    (12 records in batches of 5)."""
    tree, model = tiny_model
    loader = _port_loader(tiny_hdf5)
    try:
        assert port_extract.stream_extract_split(model, _cfgs()[1], loader,
                                                 str(tmp_path / "port.hdf5")) == 12
    finally:
        loader.close()
    spec = JaxBatchSpec(batch_size=5, image_size=32, resize_to=36, dna_max_bp=80, train=False)
    jloader = JaxLoader(tiny_hdf5, "all_keys", spec, num_workers=0)
    saved = jax_layers.ATTENTION_IMPL
    jax_layers.ATTENTION_IMPL = "pallas"
    try:
        assert jax_extract.stream_extract_split(tree, _cfgs()[0], jloader,
                                                str(tmp_path / "jax.hdf5")) == 12
    finally:
        jax_layers.ATTENTION_IMPL = saved
        jloader.close()
    _assert_same_file(tmp_path / "port.hdf5", tmp_path / "jax.hdf5", atol=EMB_ATOL)
    got = _read(tmp_path / "port.hdf5")
    for m in ("image", "dna", "language"):
        emb = got[f"encoded_{m}_feature"][1]
        assert emb.shape == (12, 64)
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1, atol=1e-5)


def test_stream_extract_kill_resume_bit_identical(tiny_hdf5, tiny_model, tmp_path):
    """Stopped after 2 of 3 batches, then torn (one dataset a few rows
    short, as a kill between two resizes leaves it), then resumed: the
    file equals an uninterrupted run's bit for bit (tests/test_extract_eval.py
    's check of the JAX package)."""
    _, model = tiny_model
    cfg = _cfgs()[1]

    def run(path, **kw):
        loader = _port_loader(tiny_hdf5)
        try:
            return port_extract.stream_extract_split(model, cfg, loader, str(path), **kw)
        finally:
            loader.close()

    assert run(tmp_path / "oneshot.hdf5") == 12
    killed = tmp_path / "killed.hdf5"
    assert run(killed, max_batches=2) == 10
    with h5py.File(killed, "r+") as f:
        f["species_list"].resize((7,))
    # consistent prefix 7 → batch boundary 5 → batches 1 and 2 run again
    assert run(killed, resume=True) == 7
    _assert_same_file(killed, tmp_path / "oneshot.hdf5")
    # resuming the whole file redoes only its ragged last batch, as in the
    # JAX package (10 rows are a batch boundary), and changes nothing
    assert run(killed, resume=True) == 2
    _assert_same_file(killed, tmp_path / "oneshot.hdf5")


TINY_EXP = """
model_output_name: tiny_export
dataset: bioscan_1m
batch_size: 5
output_dim: 32
load_ckpt: false
default_seed: 42
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 64, num_layers: 1, num_heads: 2,
        mlp_dim: 128}
dna:
  bert: {vocab_size: 1027, hidden_size: 64, num_layers: 1, num_heads: 2,
         intermediate_size: 128, max_position_embeddings: 140, with_mlm_head: true}
language:
  bert: {vocab_size: 1000, hidden_size: 64, num_layers: 1, num_heads: 2,
         intermediate_size: 128, max_position_embeddings: 24}
"""


def _cli(tmp_path, *argv):
    import clibd_tpu_torch.cli as cli

    exp = tmp_path / "tiny.yaml"
    exp.write_text(TINY_EXP)
    return cli.main([argv[0], "-e", str(exp), "--device", "cpu", *argv[1:],
                     f"project_root_path={tmp_path}", "pipeline.num_workers=0"])


def test_cli_extract_stream_resume_end_to_end(tiny_hdf5, tmp_path, capsys):
    """`extract` to one file and `extract --stream` to another hold the same
    records; a torn stream file continued with `--stream --resume` equals
    the whole one."""
    whole, streamed = tmp_path / "whole.hdf5", tmp_path / "streamed.hdf5"
    assert _cli(tmp_path, "extract", "--hdf5", tiny_hdf5, "--out", str(whole)) == 0
    assert _cli(tmp_path, "extract", "--hdf5", tiny_hdf5, "--out", str(streamed),
                "--stream") == 0
    assert "Streamed 12 embeddings" in capsys.readouterr().out
    a, b = _read(whole), _read(streamed)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k][1]), np.asarray(a[k][1]), err_msg=k)
    torn = tmp_path / "torn.hdf5"
    shutil.copy(streamed, torn)
    with h5py.File(torn, "r+") as f:
        for k in f:
            f[k].resize((8 if k == "file_name" else 6,) + f[k].shape[1:])
    assert _cli(tmp_path, "extract", "--hdf5", tiny_hdf5, "--out", str(torn), "--stream",
                "--resume") == 0
    assert "Streamed 7 embeddings" in capsys.readouterr().out
    _assert_same_file(torn, streamed)


def test_cli_extract_single_end_to_end(tmp_path):
    """`extract-single` embeds one image file and one barcode as the port's
    model does in process (fresh init from the config's seed)."""
    from clibd_tpu_torch.config import load_config
    from clibd_tpu_torch.data.pipeline import preprocess_single_image, tokenize_single_barcode
    from clibd_tpu_torch.models.clibd import clibd_apply, init_clibd_model

    jpeg = random_jpeg_bytes(np.random.default_rng(4), h=70, w=90)
    (tmp_path / "img.jpg").write_bytes(jpeg)
    barcode = "ACGT" * 40
    out = tmp_path / "emb.json"
    assert _cli(tmp_path, "extract-single", "--image", str(tmp_path / "img.jpg"), "--barcode",
                barcode, "--out", str(out)) == 0
    got = json.loads(out.read_text())
    assert set(got) == {"image_embedding", "dna_embedding"}
    mc = load_config(experiment=str(tmp_path / "tiny.yaml")).model_config
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), "cpu")
    with torch.inference_mode():
        want = clibd_apply(
            model, mc, image_input=torch.from_numpy(preprocess_single_image(mc, jpeg)[None]),
            dna_input=torch.from_numpy(tokenize_single_barcode(mc, barcode)[None]))
    for m in ("image", "dna"):
        emb = np.asarray(got[f"{m}_embedding"], np.float32)
        assert emb.shape == (32,)
        np.testing.assert_array_equal(emb, want[m][0].numpy())
