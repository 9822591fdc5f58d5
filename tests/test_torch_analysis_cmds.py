"""The port's host analysis commands against clibd_tpu's on the CPU, each
run through both command lines on the same inputs: `flatten-csv`,
`stats-summary`, `compare-experiments` (with `--poster --line-plots`),
`confusion-matrices` and `plot-embeddings`.  Each writes the same files
under its output folder and prints the same lines (its folder's name
aside); every CSV and JSON file is byte-identical, and every figure is a
non-empty file."""

import csv
import json
import os

import h5py
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from clibd_tpu.cli import main as jax_main
from clibd_tpu_torch import cli as port_cli

LEVELS = ("order", "family", "genus", "species")
TEXT_SUFFIXES = (".csv", ".json", ".tsv", ".txt")
PLOT_EXP = """
model_output_name: tiny_plots
dataset: bioscan_1m
output_dim: 16
"""


@pytest.fixture(autouse=True)
def one_thread():
    """One thread for torch and for the BLAS and OpenMP pools (t-SNE) while a
    test runs: the suite's workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def run_both(tmp_path, capsys, make_argv):
    """make_argv(out folder) → argv; each command line once → {name: (files
    relative to its folder, printed lines with the folder named OUT)}."""
    out = {}
    for name, main in (("jax", jax_main), ("port", port_cli.main)):
        folder = tmp_path / name
        folder.mkdir()
        assert main(make_argv(folder)) == 0
        printed = [line.replace(str(folder), "OUT")
                   for line in capsys.readouterr().out.strip().splitlines()]
        files = sorted(os.path.relpath(os.path.join(d, f), folder)
                       for d, _, fs in os.walk(folder) for f in fs)
        out[name] = (files, printed)
    assert out["port"] == out["jax"] and out["port"][0], out
    for rel in out["port"][0]:
        got, want = tmp_path / "port" / rel, tmp_path / "jax" / rel
        assert got.stat().st_size > 0, rel
        if rel.endswith(TEXT_SUFFIXES):
            assert got.read_bytes() == want.read_bytes(), rel
    return out["port"]


def test_flatten_csv(tmp_path, capsys):
    header = ["learning_strategy", "Alignment", "DNA_encoder", "Image_encoder",
              "Language_encoder", "Epoch", "Latent_space_dim", "Query", "Key", "Metric",
              *[f"{s}_{lv.capitalize()}" for s in ("Seen", "Unseen") for lv in LEVELS]]
    rng = np.random.default_rng(51)
    rows = [header] + [
        ["LoRA", "I,D", "bb", "vit", "bert", "50", "768", q, k, metric,
         *[f"{v:.4f}" for v in rng.random(8)]]
        for q in ("Image", "DNA") for k in ("Image", "DNA")
        for metric in ("Micro_Top-1_acc", "Macro_Top-1_acc")]
    src = tmp_path / "results.csv"
    with open(src, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    files, _ = run_both(tmp_path, capsys, lambda folder: [
        "flatten-csv", "--input", str(src), "--out", str(folder / "flat.csv")])
    assert files == ["flat.csv"]


def test_stats_summary(tiny_hdf5, tmp_path, capsys):
    files, _ = run_both(tmp_path, capsys, lambda folder: [
        "stats-summary", "--hdf5", tiny_hdf5, "--out", str(folder)])
    assert sum(f.endswith(".csv") for f in files) >= 3


def _acc(rng, pairs):
    acc = {}
    for q, k in pairs:
        acc.setdefault(q, {})[k] = {
            split: {metric: {kk: {lv: round(float(rng.random()), 4) for lv in LEVELS}
                             for kk in (1, 3, 5)}
                    for metric in ("micro_acc", "macro_acc")}
            for split in ("seen", "unseen")}
    return acc


def test_compare_experiments(tmp_path, capsys):
    rng = np.random.default_rng(52)
    pairs = [(q, k) for q in ("encoded_image_feature", "encoded_dna_feature")
             for k in ("encoded_image_feature", "encoded_dna_feature")]
    specs = []
    for name in ("expA", "expB"):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(_acc(rng, pairs)))
        specs.append(f"{name}={path}")
    files, printed = run_both(tmp_path, capsys, lambda folder: [
        "compare-experiments", *specs, "--out", str(folder), "--k", "3", "--poster",
        "--line-plots"])
    assert any(f.startswith("poster_") for f in files)
    assert any(f.startswith("line_plot_") for f in files) and len(printed) == len(files)


def test_confusion_matrices(tmp_path, capsys):
    rng = np.random.default_rng(53)
    n = 40

    def label(i):
        return {lv: f"{lv}{i % 5}" for lv in LEVELS}

    gt = [label(int(i)) for i in rng.integers(0, 5, n)]
    preds = [{lv: [f"{lv}{int(j)}"] for lv in LEVELS} for j in rng.integers(0, 5, n)]
    pred_json = tmp_path / "pred_dict_test.json"
    pred_json.write_text(json.dumps({
        "seen_gt_label": gt, "unseen_gt_label": [],
        "encoded_image_feature": {"encoded_dna_feature": {
            "curr_seen_pred_list": preds, "curr_unseen_pred_list": []}}}))
    files, _ = run_both(tmp_path, capsys, lambda folder: [
        "confusion-matrices", "--pred-json", str(pred_json), "--out", str(folder),
        "--top-n", "3"])
    assert len(files) >= 4


def test_plot_embeddings(tmp_path, capsys):
    rng = np.random.default_rng(54)
    n = 60
    feats = tmp_path / "extracted_feature_from_test_split.hdf5"
    with h5py.File(feats, "w") as f:
        g = f.create_group("key")
        for name in ("encoded_image_feature", "encoded_dna_feature"):
            emb = rng.standard_normal((n, 16)).astype(np.float32)
            g.create_dataset(name, data=emb / np.linalg.norm(emb, axis=1, keepdims=True))
    labels = tmp_path / "labels_test.json"
    labels.write_text(json.dumps({"key_gt_dict": [
        {"order": f"o{i % 3}", "family": f"f{i % 4}", "genus": f"g{i % 5}",
         "species": f"s{i % 6}"} for i in range(n)]}))
    exp = tmp_path / "plots.yaml"
    exp.write_text(PLOT_EXP)
    files, _ = run_both(tmp_path, capsys, lambda folder: [
        "plot-embeddings", "-e", str(exp), "--features", str(feats), "--labels", str(labels),
        "--group", "key", "--out", str(folder),
        "inference_and_eval_setting.embeddings_filters={}"])
    assert any(f.endswith(".png") for f in files)


@pytest.mark.parametrize("argv", [["flatten-csv", "--input", "x.csv", "--device", "cpu"],
                                  ["configs", "--device", "cpu"]])
def test_host_commands_take_no_device(argv, capsys):
    with pytest.raises(SystemExit) as e:
        port_cli.main(argv)
    assert e.value.code == 2 and "--device" in capsys.readouterr().err
