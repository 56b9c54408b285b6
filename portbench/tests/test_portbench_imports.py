"""No module of the benchmark imports JAX or the JAX package, its
references import nothing of the port, and nothing reads the TPU-era
benchmark files."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "audioanalysisdetector_tpu"}
PORT = "audioanalysisdetector_tpu_torch"
MODULES = sorted(BENCH.rglob("*.py"))


def imported_top_levels(path: Path) -> set[str]:
    """Top-level names (before the first dot) of every import in ``path``,
    wherever in the file it stands."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_walks_every_module():
    assert len(MODULES) > 20
    assert any(p.parent.name == "reference" for p in MODULES)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    # compared whole: the port's name begins with the JAX package's
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_top_levels(path)
    assert PORT not in path.read_text()


@pytest.mark.parametrize("path", [p for p in MODULES if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_no_tpu_era_benchmark(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "bench.py" not in text and "BENCH_r0" not in text


def test_guard_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from audioanalysisdetector_tpu.frontend import mel\n    import jax.numpy\n")
    assert imported_top_levels(bad) >= {"audioanalysisdetector_tpu", "jax"}
    ok = tmp_path / "ok.py"
    ok.write_text("import audioanalysisdetector_tpu_torch.score\n")
    assert not imported_top_levels(ok) & FORBIDDEN
