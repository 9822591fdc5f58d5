"""The port's released-artifact parity harness (`engine/verify_parity.py`,
`verify-parity`) against clibd_tpu's on the same files.

The synthetic release: a `best.pth` in the reference's layout
(`chip_smoke.reference_state_dict` over parameters drawn from a seeded
generator) and the embeddings the JAX package extracts with it from the
tiny HDF5, with their label and id sidecars.  Both harnesses then run the
same legs on the same artifacts (the port on the CPU); their reports must
have the same keys, the same `ok` everywhere and numbers within NUM_TOL
(fp32 throughout, so the port's re-extraction differs from the JAX
package's by float noise).
"""

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from clibd_tpu.config import load_config as jax_load_config
from clibd_tpu.engine import verify_parity as jax_vp
from clibd_tpu.engine.checkpoint import load_params_any as jax_load_params_any
from clibd_tpu.engine.extract import save_extracted_features, save_labels_and_ids
from clibd_tpu_torch.config import load_config
from clibd_tpu_torch.engine import verify_parity as port_vp

import chip_smoke

REPO = Path(__file__).resolve().parents[1]
NUM_TOL = 1e-5
# eval_spec decodes at 224 pixels: the tiny ViT takes them in 32-pixel patches
TINY_EXP = """
model_output_name: tiny_vp
dataset: bioscan_1m
amp: false
batch_size: 6
epochs: 1
output_dim: 64
disable_lora: true
load_ckpt: false
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 64, num_layers: 2, num_heads: 2,
        mlp_dim: 128}
dna:
  bert: {vocab_size: 1027, hidden_size: 64, num_layers: 2, num_heads: 2,
         intermediate_size: 128, max_position_embeddings: 140, with_mlm_head: true}
language:
  bert: {vocab_size: 1000, hidden_size: 64, num_layers: 2, num_heads: 2,
         intermediate_size: 128, max_position_embeddings: 24}
"""


@pytest.fixture(scope="module")
def release(tiny_hdf5, tmp_path_factory):
    folder = tmp_path_factory.mktemp("release")
    exp = folder / "tiny.yaml"
    exp.write_text(TINY_EXP)
    jcfg = jax_load_config(experiment=str(exp)).model_config
    pcfg = load_config(experiment=str(exp)).model_config
    ckpt = str(folder / "best.pth")
    params = chip_smoke.draw_port_params(pcfg, torch.Generator().manual_seed(30))
    torch.save(chip_smoke.reference_state_dict(params), ckpt)
    seen, unseen, keys = jax_vp.reextract(jax_load_params_any(ckpt, jcfg), jcfg, tiny_hdf5,
                                          n=None, num_workers=0, progress=False)
    feat = str(folder / "extracted_feature_from_test_split.hdf5")
    labels, ids = str(folder / "labels_test.json"), str(folder / "processed_id_test.json")
    save_extracted_features(feat, seen, unseen, keys)
    save_labels_and_ids(labels, ids, seen, unseen, keys)
    return {"exp": str(exp), "jcfg": jcfg, "pcfg": pcfg, "ckpt": ckpt, "feat": feat,
            "labels": labels, "ids": ids}


def assert_reports_match(got, want, where="report"):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_reports_match(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_reports_match(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), where
        assert (math.isnan(got) and math.isnan(want)) or abs(got - want) <= NUM_TOL, \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


def both(release, **kwargs) -> dict:
    """The JAX package's and the port's report on the same arguments."""
    kwargs.setdefault("progress", False)
    kwargs.setdefault("num_workers", 0)
    want = jax_vp.verify_parity(release["jcfg"], **kwargs)
    got = port_vp.verify_parity(release["pcfg"], device="cpu", **kwargs)
    assert_reports_match(got, want)
    assert port_vp.format_report(got).splitlines()[-1] == \
        jax_vp.format_report(want).splitlines()[-1]
    return got


def test_full_pass(release, tiny_hdf5):
    report = both(release, ckpt=release["ckpt"], released_embeddings=release["feat"],
                  hdf5=tiny_hdf5, n=None)
    assert report["ok"], port_vp.format_report(report)
    legs = report["legs"]
    assert set(legs) == {"convert", "reextract", "embedding_cosine", "species_top1"}
    assert legs["convert"]["towers"] == ["dna_encoder", "image_encoder", "language_encoder",
                                         "language_proj", "logit_scale"]
    seen = legs["embedding_cosine"]["splits"]["seen"]
    assert seen["alignment"] == "by_id" and seen["aligned_rows"] == 12
    assert seen["modalities"]["encoded_image_feature"]["min"] > 0.9999
    assert legs["species_top1"]["max_abs_delta"] == 0.0


def test_perturbed_embeddings_fail(release, tiny_hdf5, tmp_path):
    """A corrupted released artifact fails the cosine leg in both."""
    bad = str(tmp_path / "bad.hdf5")
    shutil.copy(release["feat"], bad)
    with h5py.File(bad, "r+") as f:
        d = f["seen"]["encoded_image_feature"]
        d[...] = np.random.default_rng(31).normal(size=d.shape).astype(np.float32)
    report = both(release, ckpt=release["ckpt"], released_embeddings=bad,
                  released_labels=release["labels"], released_ids=release["ids"],
                  hdf5=tiny_hdf5, n=None)
    assert not report["ok"] and not report["legs"]["embedding_cosine"]["ok"]


def test_eval_only_leg(release):
    """The released embeddings alone, then against expected values: exact
    self-comparison passes, shifted values fail."""
    report = both(release, released_embeddings=release["feat"])
    rep = report["legs"]["released_eval"]
    assert rep["ok"] and rep["species_top1"]
    expected = dict(list(rep["species_top1"].items())[:3])
    report = both(release, released_embeddings=release["feat"], expected=expected)
    assert report["legs"]["released_eval"]["max_abs_delta"] == 0.0
    shifted = {k: min(1.0, v + 0.5) for k, v in expected.items()}
    report = both(release, released_embeddings=release["feat"], expected=shifted)
    assert not report["legs"]["released_eval"]["ok"]


def test_positional_alignment(release, tiny_hdf5, tmp_path):
    """A bare released HDF5 (no sidecars) compares positionally."""
    bare = str(tmp_path / "extracted_feature_from_test_split.hdf5")
    shutil.copy(release["feat"], bare)
    report = both(release, ckpt=release["ckpt"], released_embeddings=bare, hdf5=tiny_hdf5,
                  n=None)
    assert report["ok"], port_vp.format_report(report)
    assert report["legs"]["embedding_cosine"]["splits"]["seen"]["alignment"] == "positional"


@pytest.mark.parametrize("sidecars", [True, False], ids=["by_id", "positional"])
def test_n_slice(release, tiny_hdf5, tmp_path, sidecars):
    """--n 7 re-extracts the head of each split; both sides are scored over
    the same aligned rows."""
    feat = release["feat"]
    extra = dict(released_labels=release["labels"], released_ids=release["ids"])
    if not sidecars:
        feat = str(tmp_path / "extracted_feature_from_test_split.hdf5")
        shutil.copy(release["feat"], feat)
        extra = {}
    report = both(release, ckpt=release["ckpt"], released_embeddings=feat, hdf5=tiny_hdf5,
                  n=7, **extra)
    assert report["legs"]["reextract"]["n_seen"] == 7
    assert report["legs"]["embedding_cosine"]["splits"]["seen"]["aligned_rows"] == 7
    assert report["legs"]["species_top1"]["max_abs_delta"] == 0.0
    assert report["ok"], port_vp.format_report(report)


def test_tokenizer_leg(release, tiny_hdf5, tmp_path):
    """The tokenizer leg on the HDF5's barcodes: an HF tokenizer.json over
    the k-mer vocabulary, and one with the vocabulary scrambled."""
    from tests.test_verify_parity import _build_fixture_tokenizer_json

    tok = _build_fixture_tokenizer_json(str(tmp_path / "tokenizer.json"))
    report = both(release, tokenizer_file=tok, hdf5=tiny_hdf5)
    assert report["ok"] and report["legs"]["tokenizer"]["id_match_frac"] == 1.0
    barcodes = ["".join(np.random.default_rng(32).choice(list("ACGT"), 660)) for _ in range(4)]
    with open(tok) as f:
        spec = json.load(f)
    vocab = spec["model"]["vocab"]
    names = sorted(vocab, key=vocab.get)
    spec["model"]["vocab"] = {t: i for i, t in enumerate(names[:3] + names[3:][::-1])}
    bad = str(tmp_path / "bad_tokenizer.json")
    with open(bad, "w") as f:
        json.dump(spec, f)
    want = jax_vp.tokenizer_report(bad, barcodes)
    got = port_vp.tokenizer_report(bad, barcodes)
    assert_reports_match(got, want)
    assert not got["ok"]


def test_cli_verify_parity_on_cpu(release, tiny_hdf5, tmp_path):
    """`verify-parity --device cpu` end to end: exit code 0 and the JSON
    report; a corrupted release exits 1."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = str(tmp_path / "report.json")

    def run(feat):
        return subprocess.run(
            [sys.executable, "-m", "clibd_tpu_torch.cli", "verify-parity", "-e", release["exp"],
             "--device", "cpu", "--ckpt", release["ckpt"], "--released-embeddings", feat,
             "--hdf5", tiny_hdf5, "--n", "0", "--out", out, "pipeline.num_workers=0"],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)

    proc = run(release["feat"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "OVERALL: PASS" in proc.stdout
    with open(out) as f:
        assert json.load(f)["ok"]
    bad = str(tmp_path / "bad.hdf5")
    shutil.copy(release["feat"], bad)
    with h5py.File(bad, "r+") as f:
        f["unseen"]["encoded_dna_feature"][...] = 0.5
    proc = run(bad)
    assert proc.returncode == 1 and "OVERALL: FAIL" in proc.stdout
