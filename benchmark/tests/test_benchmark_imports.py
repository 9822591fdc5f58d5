"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names; the plain reference imports nothing of the program;
nothing names the JAX package's old benchmark files."""

import ast
from pathlib import Path

from benchmark.core.cell import BENCH

JAX = {"jax", "jaxlib", "flax", "clibd_tpu"}
REFERENCE_MAY = {"__future__", "math", "typing", "numpy", "torch"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_jax():
    assert sources()
    for path in sources():
        assert not top_level_imports(path) & JAX, path


def test_the_port_is_allowed_by_its_whole_name():
    """`clibd_tpu_torch` begins with `clibd_tpu` but is another name."""
    assert "clibd_tpu_torch" not in JAX
    assert any("clibd_tpu_torch" in top_level_imports(p) for p in sources())


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert top_level_imports(path) <= REFERENCE_MAY, path


def test_no_old_benchmark_files_named():
    for path in sources():
        if path.name == Path(__file__).name:
            continue
        text = path.read_text()
        for name in ("BENCH_r", "MULTICHIP_r", "BASELINE.json", "/bench.py"):
            assert name not in text, (path, name)
