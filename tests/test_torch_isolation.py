"""The port stands alone: nothing under sign_language_nlp_torch/, and
neither chip_smoke.py nor the port's GPU scripts, imports the
JAX package or a module that the card's machine does not have, at the
top of a module or inside a function.

Two checks: an AST scan of every import statement, and a subprocess
that imports every module of the port and `chip_smoke`, then reads
`sys.modules` (this process has JAX loaded already).
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "sign_language_nlp_torch"
# The JAX package, and modules the card's machine does not have.
FORBIDDEN = ("sign_language_nlp_tpu", "jax", "flax", "yaml", "msgpack",
             "sklearn", "pandas")
SCANNED = sorted([*PORT.rglob("*.py"), REPO / "chip_smoke.py",
                  REPO / "scripts" / "profile_torch_serving.py",
                  REPO / "scripts" / "time_attention_kernels.py",
                  REPO / "scripts" / "profile_torch_training.py"])


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SCANNED,
                         ids=[str(p.relative_to(REPO)) for p in SCANNED])
def test_no_forbidden_import_statement(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_scan_sees_imports_inside_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from jax import numpy\n    import yaml\n")
    assert _imported_roots(src) == {"jax", "yaml"}


def test_importing_the_port_loads_no_forbidden_module():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import sign_language_nlp_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted({{m.split('.')[0] for m in sys.modules}}"
        f" & set({FORBIDDEN!r}))\n"
        "print(json.dumps({'n': len(names), 'bad': bad}))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == [] and result["n"] >= 25
