"""The port stands alone and runs on the card unless told otherwise.

- Every Python file of `clibd_tpu_torch/` (its `tools/` included) and
  `chip_smoke.py`, parsed with `ast`: no import of jax and none of the JAX
  package `clibd_tpu` (only `clibd_tpu_torch`).  The repo's own `tools/`
  belong to the JAX package and are not walked.
- Every entry point defaults to the card ("cuda"); a missing card is an
  error, never a silent CPU run.
"""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "clibd_tpu_torch").rglob("*.py"))
PORT_FILES.append("chip_smoke.py")
FORBIDDEN = {"jax", "jaxlib", "clibd_tpu"}


def _absolute_imports(path: str):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_the_walk_covers_the_port():
    assert "chip_smoke.py" in PORT_FILES
    for tool in ("profile_extract", "exp_attn", "exp_mxu", "exp_mxu2", "exp_flash",
                 "exp_mlp_activation", "dryrun_multigpu"):
        assert f"clibd_tpu_torch/tools/{tool}.py" in PORT_FILES
    for module in ("engine/train.py", "engine/serve.py", "engine/extract.py", "ops/knn.py",
                   "cli/extract_cmds.py", "cli/ops_cmds.py", "tools/bench_serve.py",
                   "parallel/__init__.py", "parallel/mesh.py", "engine/simclr.py",
                   "engine/retrieval_grid.py", "analysis/__init__.py", "analysis/attention_maps.py",
                   "analysis/failure_cases.py", "analysis/distributions.py", "analysis/tables.py",
                   "analysis/statistics.py", "analysis/per_class.py", "analysis/compare.py",
                   "data/bins.py", "data/splits.py", "data/builders.py", "data/builders_5m.py",
                   "data/subset.py", "data/ncbi.py", "cli/data_cmds.py", "cli/analysis_cmds.py",
                   "tools/bench.py", "tools/bench_train.py", "tools/rehearse.py",
                   "tools/exp_bwd_floor.py", "tools/exp_prof.py", "tools/exp_block.py",
                   "tools/exp_bert.py", "tools/bench_knn.py", "tools/bench_eval.py",
                   "tools/bench_extract.py", "tools/bench_pipeline.py", "tools/bench_decode.py",
                   "tools/soak_train.py", "tools/soak_extract.py", "tools/soak_serve.py",
                   "tools/fixtures.py"):
        assert f"clibd_tpu_torch/{module}" in PORT_FILES
    assert len(PORT_FILES) >= 80, PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES)
def test_file_imports_neither_jax_nor_the_jax_package(path):
    bad = [name for name in _absolute_imports(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_walk_catches_a_forbidden_import(tmp_path, monkeypatch):
    (tmp_path / "m.py").write_text("import os\nfrom clibd_tpu.config import load_config\n"
                                   "from .x import y\nimport jax.numpy as jnp\n")
    monkeypatch.setattr(sys.modules[__name__], "REPO", tmp_path)
    names = list(_absolute_imports("m.py"))
    assert names == ["os", "clibd_tpu.config", "jax.numpy"]


def _entry_points():
    from clibd_tpu_torch.engine.checkpoint import load_model_any
    from clibd_tpu_torch.engine.evaluate import inference_and_eval
    from clibd_tpu_torch.engine.fusion import (fit_frozen_probe, fit_linear_probe, method_linear,
                                               method_nn, train_linear_probe)
    from clibd_tpu_torch.engine.verify_parity import verify_parity
    from clibd_tpu_torch.engine.serve import InferenceService, KeySet
    from clibd_tpu_torch.engine.simclr import SimCLRTrainer
    from clibd_tpu_torch.engine.train import Trainer
    from clibd_tpu_torch.models import init_clibd_model, model_from_jax
    from clibd_tpu_torch.ops.knn import (find_k_closest_records, knn_search, make_prediction,
                                         prepare_keys)
    from clibd_tpu_torch.parallel import create_mesh, maybe_initialize_distributed
    from clibd_tpu_torch.utils.profiling import PhaseTimer, StepTimer
    from clibd_tpu_torch.analysis.attention_maps import (bert_attention_probs, encoder_tensors,
                                                         vit_attention_probs)
    from clibd_tpu_torch.analysis.failure_cases import find_failures, save_paired_failure_cases
    from clibd_tpu_torch.engine.retrieval_grid import (retrieval_records, retrieve_images,
                                                       retrieve_images_multi)
    from clibd_tpu_torch.tools import (bench_eval, bench_extract, bench_knn, bench_train,
                                       exp_prof, rehearse, soak_extract, soak_train)
    from clibd_tpu_torch.tools.bench import run_bench

    return {"vit_attention_probs": vit_attention_probs,
            "bert_attention_probs": bert_attention_probs, "encoder_tensors": encoder_tensors,
            "find_failures": find_failures, "save_paired_failure_cases": save_paired_failure_cases,
            "retrieval_records": retrieval_records, "retrieve_images": retrieve_images,
            "retrieve_images_multi": retrieve_images_multi, "run_bench": run_bench,
            "create_mesh": create_mesh,
            "maybe_initialize_distributed": maybe_initialize_distributed,
            "SimCLRTrainer": SimCLRTrainer.__init__,"init_clibd_model": init_clibd_model, "model_from_jax": model_from_jax,
            "inference_and_eval": inference_and_eval,
            "prepare_keys": prepare_keys, "Trainer": Trainer.__init__, "knn_search": knn_search,
            "find_k_closest_records": find_k_closest_records, "make_prediction": make_prediction,
            "StepTimer": StepTimer.__init__, "PhaseTimer": PhaseTimer.__init__,
            "InferenceService": InferenceService.__init__, "KeySet": KeySet.__init__,
            "KeySet.from_arrays": KeySet.from_arrays, "load_model_any": load_model_any,
            "verify_parity": verify_parity, "method_nn": method_nn,
            "method_linear": method_linear, "fit_frozen_probe": fit_frozen_probe,
            "train_linear_probe": train_linear_probe, "fit_linear_probe": fit_linear_probe,
            "bench_train.bench": bench_train.bench, "bench_train.sweep": bench_train.sweep,
            "rehearse.run": rehearse.run, "exp_prof.run": exp_prof.run,
            "bench_knn.device_leg": bench_knn.device_leg, "bench_knn.full_leg": bench_knn.full_leg,
            "bench_knn.bench_int8": bench_knn.bench_int8, "bench_eval.run": bench_eval.run,
            "bench_extract.run": bench_extract.run, "soak_train.run": soak_train.run,
            "soak_extract.run": soak_extract.run, "soak_extract.verify": soak_extract.verify,
            "soak_extract.stream": soak_extract.stream}


@pytest.mark.parametrize("name", ["init_clibd_model", "model_from_jax",
                                  "inference_and_eval", "prepare_keys", "Trainer", "knn_search",
                                  "find_k_closest_records", "make_prediction", "StepTimer",
                                  "PhaseTimer", "InferenceService", "KeySet",
                                  "KeySet.from_arrays", "load_model_any", "verify_parity",
                                  "method_nn", "method_linear", "fit_frozen_probe",
                                  "train_linear_probe", "fit_linear_probe", "create_mesh",
                                  "maybe_initialize_distributed", "SimCLRTrainer",
                                  "vit_attention_probs", "bert_attention_probs",
                                  "encoder_tensors", "find_failures", "save_paired_failure_cases",
                                  "retrieval_records", "retrieve_images", "retrieve_images_multi",
                                  "run_bench", "bench_train.bench", "bench_train.sweep",
                                  "rehearse.run", "exp_prof.run", "bench_knn.device_leg",
                                  "bench_knn.full_leg", "bench_knn.bench_int8", "bench_eval.run",
                                  "bench_extract.run", "soak_train.run", "soak_extract.run",
                                  "soak_extract.verify", "soak_extract.stream"])
def test_entry_point_defaults_to_cuda(name):
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("command", ["train", "eval", "extract", "extract-single", "serve",
                                     "verify-parity", "finetune", "bzsl-extract", "method-nn",
                                     "zeroshot", "attention-maps", "failure-cases", "doctor",
                                     "bench"])
def test_cli_defaults_to_cuda_with_no_fallback(command):
    proc = subprocess.run([sys.executable, "-m", "clibd_tpu_torch.cli", command, "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "default: cuda" in proc.stdout
    assert "is_available" not in (REPO / "clibd_tpu_torch/cli/__init__.py").read_text()


def test_a_missing_card_is_an_error():
    """With no device given, an entry point goes to the card: where there
    is none it raises instead of running on the CPU."""
    from clibd_tpu_torch.ops.knn import prepare_keys

    keys = torch.ones(3, 4)
    if torch.cuda.is_available():
        assert prepare_keys(keys).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        prepare_keys(keys)


@pytest.mark.parametrize("call", ["knn_search", "make_prediction", "StepTimer", "PhaseTimer"])
def test_numpy_inputs_and_timers_go_to_the_card(call):
    """kNN on numpy inputs and the timers' synchronisation go to the card
    unless told otherwise: without one they raise instead of running on the
    CPU."""
    import numpy as np

    from clibd_tpu_torch.ops.knn import knn_search, make_prediction
    from clibd_tpu_torch.utils.profiling import PhaseTimer, StepTimer

    def one_phase():
        with PhaseTimer().phase("x"):
            pass

    q = np.eye(3, 4, dtype=np.float32)
    labels = [dict.fromkeys(("order", "family", "genus", "species"), "x")] * 3
    run = {"knn_search": lambda: knn_search(q, q, k=2),
           "make_prediction": lambda: make_prediction(q, q, labels, max_k=2),
           "StepTimer": lambda: StepTimer(warmup_steps=0).tick(),
           "PhaseTimer": one_phase}[call]
    if torch.cuda.is_available():
        run()
        return
    with pytest.raises((AssertionError, RuntimeError)):
        run()


SERVE_EXP = """
model_output_name: no_card
dataset: bioscan_1m
output_dim: 16
load_ckpt: false
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 32, num_layers: 1, num_heads: 2,
        mlp_dim: 64}
dna:
  bert: {vocab_size: 1027, hidden_size: 32, num_layers: 1, num_heads: 2,
         intermediate_size: 64, max_position_embeddings: 140, with_mlm_head: true}
language:
  bert: {vocab_size: 1000, hidden_size: 32, num_layers: 1, num_heads: 2,
         intermediate_size: 64, max_position_embeddings: 24}
"""


@pytest.mark.parametrize("argv", [["extract-single", "--barcode", "ACGTACGT"],
                                  ["serve", "--port", "0", "--no-warm"],
                                  ["extract", "--hdf5", "missing.hdf5", "--stream"]])
def test_export_and_serve_commands_need_the_card(argv, tmp_path):
    """Without `--device cpu` the new subcommands go to the card: where there
    is none they exit with an error before any work, never on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the commands would run on it")
    exp = tmp_path / "exp.yaml"
    exp.write_text(SERVE_EXP)
    proc = subprocess.run([sys.executable, "-m", "clibd_tpu_torch.cli", argv[0], "-e", str(exp),
                           *argv[1:], f"project_root_path={tmp_path}"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr, proc.stderr[-2000:]
    assert "serving on" not in proc.stdout


ANALYSIS_IMPORT = """
import torch
calls = []
real = torch.cuda._lazy_init
torch.cuda._lazy_init = lambda: calls.append(1) or real()
import clibd_tpu_torch.analysis as analysis
names = list(analysis.__all__)
for name in names:
    exec(f"from clibd_tpu_torch.analysis import {name}")
print(len(names), "names;", "lazy_init calls:", len(calls), torch.cuda.is_initialized())
"""


def test_the_analysis_package_exports_the_jax_names_without_cuda():
    """`clibd_tpu_torch.analysis` exports the 32 names of clibd_tpu's
    (`analysis/__init__.py`), each importable with CUDA left untouched."""
    tree = ast.parse((REPO / "clibd_tpu" / "analysis" / "__init__.py").read_text())
    want = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "__all__")
    import clibd_tpu_torch.analysis as analysis

    assert list(analysis.__all__) == want and len(want) == 32
    proc = subprocess.run([sys.executable, "-c", ANALYSIS_IMPORT], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "32 names; lazy_init calls: 0 False" in proc.stdout
