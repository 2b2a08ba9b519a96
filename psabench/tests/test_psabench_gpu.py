"""On the card (marker `gpu`; skips without one): each cell runs a short
window end to end, its answers correct, its result line complete."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from psabench import registry

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["single.long_seq2", "batch.long_rows"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "-m", "psabench.run", "--workload",
                        cell, "--seed", "2718281828", "--seconds", "3",
                        "--trace", str(trace)], cwd=REPO, text=True,
                       capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    want = {registry.metric_name(m) for m in registry.metrics()
            if m.KIND == kind and cell in getattr(m, "WORKLOADS", (cell,))}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["metrics"]["kernels_roofline"]["value"] < 100
