"""What the harness imports: never JAX or the JAX package (top-level names
compared whole: the port's ``repro_torch`` begins with ``repro`` and is
allowed), nothing of the port in the reference, and none of the JAX
package's benchmark records."""
import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(harness.__file__).resolve().parent
FOREIGN = {"jax", "jaxlib", "flax", "repro"}


def _sources(sub: str = ""):
    return [p for p in sorted((HERE / sub).rglob("*.py"))
            if "tests" not in p.relative_to(HERE).parts]


def _imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports (absolute ones)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_harness_sources_import_no_jax():
    found = {str(p.relative_to(HERE)): _imported(p) & FOREIGN
             for p in _sources()}
    assert not any(found.values()), found
    # the scan compares whole names: the port itself is imported somewhere
    assert any("repro_torch" in _imported(p) for p in _sources())


def test_reference_imports_nothing_of_the_port():
    for p in _sources("reference"):
        assert _imported(p) <= {"__future__", "math", "torch"}, p


def test_harness_reads_no_jax_records():
    for p in _sources():
        text = p.read_text()
        for name in ("BENCH_phi", "chip_smoke", "benchmarks/"):
            assert name not in text, (p, name)


@pytest.mark.parametrize("module,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("repro", True), ("repro.core.cpapr", True), ("repro_torch", False),
    ("repro_torch.core.cpapr", False), ("jaxtyping", False),
    ("reprox", False)])
def test_foreign_modules_compares_whole_top_level_names(monkeypatch, module,
                                                        flagged):
    monkeypatch.setitem(sys.modules, module, object())
    assert (module in harness.foreign_modules()) == flagged
