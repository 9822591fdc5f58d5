"""The port's command line against clibd_tpu's on the CPU: all 26
subcommands parse `--help` (the device commands with `--device` defaulting
to the card, the host commands with no `--device`), `configs` lists what the
JAX command lists, `doctor --device cpu` reports what the JAX command
reports (torch's version where jax's was), `bench` on a tiny model
prints one JSON line, and a host command leaves CUDA untouched."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from clibd_tpu.cli import main as jax_main
from clibd_tpu_torch import cli as port_cli
from clibd_tpu_torch.tools import bench as port_bench

REPO = Path(__file__).resolve().parents[1]

COMMANDS = ("train", "eval", "extract", "simclr", "create-splits", "build-hdf5", "bzsl-extract",
            "extract-single", "serve", "doctor", "finetune", "method-nn", "zeroshot",
            "flatten-csv", "plot-embeddings", "fetch-taxonomy", "stats-summary",
            "compare-experiments", "confusion-matrices", "attention-maps", "subset-hdf5",
            "generate-split-csv", "failure-cases", "verify-parity", "configs", "bench")
HOST_COMMANDS = {"create-splits", "build-hdf5", "subset-hdf5", "generate-split-csv",
                 "fetch-taxonomy", "flatten-csv", "plot-embeddings", "stats-summary",
                 "compare-experiments", "confusion-matrices", "configs"}

DOCTOR_EXP = """
model_output_name: tiny_doctor
dataset: bioscan_1m
output_dim: 16
load_ckpt: false
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_port_has_the_jax_commands():
    """The 26 commands of clibd_tpu's dispatcher, each with its `cmd_` body
    in the port's."""
    jax_cli = (REPO / "clibd_tpu" / "cli" / "__init__.py").read_text()
    port_cli_src = (REPO / "clibd_tpu_torch" / "cli" / "__init__.py").read_text()
    assert len(set(COMMANDS)) == 26 and jax_cli.count('": cmd_') == 26
    for command in COMMANDS:
        body = "cmd_" + command.replace("-", "_")
        assert f'"{command}": {body}' in jax_cli, command
        assert f'"{command}": {body}' in port_cli_src and callable(getattr(port_cli, body))


@pytest.mark.parametrize("command", COMMANDS)
def test_every_subcommand_parses_help(command, capsys):
    with pytest.raises(SystemExit) as e:
        port_cli.main([command, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    if command in HOST_COMMANDS:
        assert "--device" not in out
    else:
        assert "--device" in out and "default: cuda" in out


def test_configs_lists_what_jax_lists(capsys):
    assert jax_main(["configs"]) == 0
    want = capsys.readouterr().out
    assert port_cli.main(["configs"]) == 0
    got = capsys.readouterr().out
    assert got == want
    yamls = list((REPO / "clibd_tpu" / "config" / "configs").rglob("*.yaml"))
    assert len(got.splitlines()) == len(yamls) > 40


def _doctor(main, argv, capsys):
    rc = main(["doctor", *argv])
    out = capsys.readouterr().out
    return rc, json.loads(out[out.index("{"):])


def test_doctor_reports_what_jax_reports(tiny_hdf5, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "doctor.yaml"
    exp.write_text(DOCTOR_EXP)
    common = ["-e", str(exp), "--timeout", "120", f"model_output_dir={tmp_path}/out",
              f"project_root_path={tmp_path}"]
    rc_j, want = _doctor(jax_main, ["--hdf5", tiny_hdf5, *common], capsys)
    rc_p, got = _doctor(port_cli.main, ["--device", "cpu", "--hdf5", tiny_hdf5, *common], capsys)
    assert rc_j == rc_p == 0 and got["status"] == want["status"] == "ok"
    assert set(got) - {"torch"} == set(want) - {"jax"} and got["torch"] == torch.__version__
    assert set(got["device"]) == set(want["device"])
    assert got["device"]["status"] == "ok" and got["device"]["platform"] == "cpu"
    assert got["device"]["process_count"] == 1 and got["device"]["distributed"] is False
    assert got["native_decoder"] == want["native_decoder"]
    assert got["experiment"] == want["experiment"]
    assert got["experiment"]["hdf5"]["exists"] is True
    assert got["experiment"]["checkpoint"]["would_fresh_init"] is True
    # a missing dataset flips hdf5.exists (still rc 0: existence is
    # reported, not judged)
    rc, missing = _doctor(port_cli.main, ["--device", "cpu", "--hdf5", "/nope/missing.h5",
                                          *common], capsys)
    assert rc == 0 and missing["experiment"]["hdf5"]["exists"] is False


def test_doctor_reports_a_device_failure(capsys):
    """A device the probe cannot use is reported in the JSON (rc 1), not
    raised."""
    rc, report = _doctor(port_cli.main, ["--device", "meta-nonexistent", "--timeout", "60"],
                         capsys)
    assert rc == 1 and report["status"] == "problems"
    assert report["device"]["status"] == "error" and "exception" in report["device"]


def test_bench_body_on_a_tiny_model(monkeypatch, capsys):
    """`bench --device cpu` with the benchmark's model patched to a tiny one:
    one JSON line with a positive samples/s and no card."""
    from tests.torch_tiny import port_tiny_cfg

    def tiny():
        cfg = port_tiny_cfg()
        cfg.language.enable = False
        cfg.disable_lora = True
        cfg.dna.bert.max_position_embeddings = 140
        return cfg

    monkeypatch.setattr(port_bench, "flagship_config", tiny)
    monkeypatch.setattr(port_bench, "BATCH", 2)
    assert port_cli.main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["value"] > 0 and record["unit"] == "samples/s"
    assert record["metric"] == "image+DNA embeddings/sec/card"
    assert record["device"] == "cpu" and record["card"] is None
    assert "vs_baseline" not in record


def test_bench_runs_the_flagship():
    """The model the command line benchmarks: ViT-B/16 + BarcodeBERT at full
    width, no text tower, no LoRA."""
    cfg = port_bench.flagship_config()
    assert (cfg.image.vit.hidden_size, cfg.image.vit.num_layers, cfg.image.vit.patch_size,
            cfg.dna.bert.hidden_size, cfg.dna.bert.num_layers) == (768, 12, 16, 768, 12)
    assert not cfg.language.enable and cfg.disable_lora and cfg.output_dim == 768


HOST_RUN = """
import sys, torch
calls = []
real = torch.cuda._lazy_init
torch.cuda._lazy_init = lambda: calls.append(1) or real()
from clibd_tpu_torch.cli import main
assert main(sys.argv[1:]) == 0
print("cuda initialised:", torch.cuda.is_initialized(), "lazy_init calls:", len(calls))
"""


def test_a_host_command_leaves_cuda_uninitialised(tmp_path):
    src = tmp_path / "results.csv"
    src.write_text("learning_strategy,Alignment,DNA_encoder,Image_encoder,Language_encoder,"
                   "Epoch,Latent_space_dim,Query,Key,Metric,Seen_Order,Seen_Family,Seen_Genus,"
                   "Seen_Species,Unseen_Order,Unseen_Family,Unseen_Genus,Unseen_Species\n"
                   "LoRA,\"I,D\",bb,vit,bert,50,768,Image,DNA,Micro_Top-1_acc,0.9,0.8,0.7,0.6,"
                   "0.5,0.4,0.3,0.2\n")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", HOST_RUN, "flatten-csv", "--input", str(src),
                           "--out", str(tmp_path / "flat.csv")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "cuda initialised: False lazy_init calls: 0" in proc.stdout
    assert (tmp_path / "flat.csv").exists()
