"""What the benchmark runs imports neither JAX nor the JAX package, reads
nothing of the old `benchmarks/`, and its reference imports nothing of
the program.  Top-level module names are compared whole, so
`repro_torch` is not `repro`."""
import ast
from pathlib import Path

import pytest

from portbench.harness import runner

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path):
    """Top-level names of every module `path` imports (relative imports
    are the benchmark's own and give none)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_harness_has_sources():
    assert BENCH / "run.py" in SOURCES
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro",
                                          "benchmarks"}
    assert "benchmarks/" not in path.read_text()


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert top_level_imports(path) <= {"torch", "__future__", "typing"}


def test_whole_name_comparison():
    assert runner.forbidden_modules(["repro_torch", "repro_torch.core",
                                     "reprox", "torch"]) == []
    assert runner.forbidden_modules(["repro", "repro.core.graph", "jax",
                                     "jaxlib.xla", "flax.linen",
                                     "repro_torch"]) == [
        "flax.linen", "jax", "jaxlib.xla", "repro", "repro.core.graph"]
