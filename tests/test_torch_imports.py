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
    assert "clibd_tpu_torch/tools/profile_extract.py" in PORT_FILES
    assert "clibd_tpu_torch/engine/train.py" in PORT_FILES
    assert len(PORT_FILES) >= 45, PORT_FILES


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
    from clibd_tpu_torch.engine.evaluate import inference_and_eval
    from clibd_tpu_torch.engine.train import Trainer
    from clibd_tpu_torch.models import init_clibd_model, load_model_npz, model_from_jax
    from clibd_tpu_torch.ops.knn import prepare_keys

    return {"init_clibd_model": init_clibd_model, "model_from_jax": model_from_jax,
            "load_model_npz": load_model_npz, "inference_and_eval": inference_and_eval,
            "prepare_keys": prepare_keys, "Trainer": Trainer.__init__}


@pytest.mark.parametrize("name", ["init_clibd_model", "model_from_jax", "load_model_npz",
                                  "inference_and_eval", "prepare_keys", "Trainer"])
def test_entry_point_defaults_to_cuda(name):
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("command", ["train", "eval"])
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
