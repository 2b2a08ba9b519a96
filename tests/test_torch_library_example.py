"""examples/library_usage_torch.py, the port's library quickstart: every
surface it shows gives the JAX package's numpy engine's winners on the
same queries, and the script runs on the CPU without a card, importing
neither JAX nor psa_tpu."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from psa_tpu.core.alphabet import decode
from psa_tpu.models.search import AlignmentSearchEngine
from psa_tpu.utils.generator import random_sequences

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "examples" / "library_usage_torch.py"


def _example():
    spec = importlib.util.spec_from_file_location("library_usage_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy(seq1, seq2):
    return AlignmentSearchEngine(np.array([1.0, 3.0, 4.0, 2.0]), False,
                                 backend="numpy").search(seq1, seq2)


def _winner(r):
    return (r.offset, r.char_offset, r.sub_code, r.score)


def _expected(surface):
    if surface == "single_query":
        return [_numpy(*random_sequences(5_000, 800, seed=0))]
    if surface == "batch_serving":
        return [_numpy(*random_sequences(n1, n2, seed=s))
                for s, (n1, n2) in enumerate([(3_000, 500), (3_000, 500), (1_200, 200)])]
    if surface == "sharded":
        return [_numpy(*random_sequences(20_000, 2_000, seed=1))]
    if surface == "sharded_auto_2d":
        return [_numpy(*random_sequences(6_000, 2_000, seed=2))]
    c1b, c2b, noffs, n2s = _example().sharded_batch_queries()
    return [_numpy(decode(c1[: noff + n2 - 1]), decode(c2[:n2]))
            for c1, c2, noff, n2 in zip(c1b, c2b, noffs, n2s)]


@pytest.mark.parametrize("surface", ["single_query", "batch_serving", "sharded",
                                     "sharded_auto_2d", "sharded_batch_serving"])
def test_example_surface_matches_numpy(surface, capsys):
    got = getattr(_example(), surface)("cpu")
    got = got if isinstance(got, list) else [got]
    assert [_winner(r) for r in got] == [_winner(r) for r in _expected(surface)]
    assert capsys.readouterr().out.strip()


def test_example_runs_as_a_script_without_jax():
    code = ("import runpy, sys; runpy.run_path(sys.argv[1], run_name='__main__'); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'psa_tpu')))")
    out = subprocess.run([sys.executable, "-c", code, str(EXAMPLE)], cwd=ROOT / "tests",
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "[]"
    assert any(ln.startswith("sharded batch (") for ln in lines)
    if not torch.cuda.is_available():
        assert lines[0].startswith("no CUDA device: running on the CPU")
