"""Nothing of the benchmark loads JAX or the JAX package, and its
reference loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from gpubench import core

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    """Top-level module names a file imports (absolute imports only;
    relative ones stay inside the benchmark)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        found = set(_imports(f)) & set(core.FORBIDDEN)
        assert not found, (f, found)


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py")) + sorted(
        (BENCH / "checks").rglob("*.py"))
    for f in files:
        names = set(_imports(f))
        assert "turbosqueeze_tpu_torch" not in names, f
        # gpubench: the reference itself, from the checks
        assert names <= {"__future__", "multiprocessing", "concurrent",
                         "numpy", "struct", "gpubench"}, (f, names)


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; from gpubench import core, drive, run, "
            "control; from turbosqueeze_tpu_torch.runtime import api, jobs, "
            "native; print(core.forbidden_loaded())")
    r = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
