"""Nothing the benchmark runs imports JAX or the JAX package, and its
references import nothing of the program either (one may import another
reference's shared parts): top-level module names compared whole (the
port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "svnicp_tpu"}


def imports(path: Path) -> set:
    """The absolute module names a source imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def top_level_imports(path: Path) -> set:
    return {name.split(".")[0] for name in imports(path)}


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    other = {n for n in imports(path) if n.split(".")[0] == "lio_bench"}
    assert all(n == "lio_bench.reference" or n.startswith("lio_bench.reference.")
               for n in other), other
    assert top_level_imports(path) - {"lio_bench"} <= {"__future__", "dataclasses",
                                                       "math", "numpy", "torch"}


def test_the_name_check_compares_whole_top_level_names():
    from lio_bench.harness.cell import FORBIDDEN as HARNESS

    assert "svnicp_tpu_torch".split(".")[0] not in HARNESS
    assert set(HARNESS) == FORBIDDEN


def test_a_run_loads_no_jax(small):
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from lio_bench.harness import cell;"
            f"cell.run_cell('geode_alpha.live10hz', 3, 1.0, False, device='cpu', overrides={small!r});"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'flax', 'svnicp_tpu'))))")
    p = subprocess.run([sys.executable, "-c", code, str(BENCH.parent)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
