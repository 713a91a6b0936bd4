"""What runs on the card imports neither JAX nor the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: `upnerf_torch` begins with `upnerf` and is not it."""

import ast
import subprocess
import sys
from pathlib import Path

from tiny import ROOT

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "upnerf"}


def top_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_a_dry_run_of_every_cell_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from tiny import CELLS, PREPROCESS, run_cell\n"
        "for c in CELLS + (PREPROCESS,):\n"
        "    rc, res = run_cell(c, seconds=0.2)\n"
        "    assert rc == 0 and res is not None, c\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % (str(ROOT), str(BENCH / "tests"))
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "upnerf_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_no_file_of_the_harness_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" not in path.relative_to(BENCH).parts:
            assert not top_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not top_imports(path) & (FORBIDDEN | {"upnerf_torch", "portbench"}), path
