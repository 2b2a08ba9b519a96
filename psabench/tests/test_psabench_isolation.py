"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the reference takes nothing of the
program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from psabench import run

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "psa_tpu"}


def imports(path: Path) -> set:
    """Top-level names of every import statement in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=[p.name for p in SOURCES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    assert imports(PKG / "reference.py") <= {"__future__", "numpy", "torch"}


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["jax.numpy", "os"]) == ["jax"]
    assert run.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert run.forbidden_modules(["psa_tpu.models.search"]) == ["psa_tpu"]
    assert run.forbidden_modules(["psa_torch", "psa_torch.models", "jaxtyping",
                                  "psa_tpu_notes", "numpy"]) == []


def test_a_run_loads_no_jax(tmp_path):
    """Every psabench module imported and a small run made in a new
    process: no forbidden top-level module is loaded."""
    code = """
import importlib, json, pkgutil, sys, time, torch
import psabench
for m in pkgutil.walk_packages(psabench.__path__, "psabench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from psabench import registry, run
for cell in registry.cells():
    run.run_cell(registry.cell(cell), 3, 0.2, True, torch.device("cpu"),
                 time.perf_counter(), {"seq1_len": 600, "seq2_len": 80},
                 log=lambda line: None)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                       capture_output=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "psa_torch" in loaded and not loaded & FORBIDDEN
