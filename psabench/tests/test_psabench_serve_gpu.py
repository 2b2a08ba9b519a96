"""On the card (marker `gpu`; skips without one): the cells of
test_psabench_serve.py's list run a short window end to end, their answers
correct, their result lines complete, and the traced run's device work
names the kernel each cell exists for."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from psabench import registry

REPO = Path(__file__).resolve().parents[2]
KERNEL = {"serve.tcp_closed": "sweep_batched_kernel<false>",
          "batch.long_shared": "sweep_batched_kernel<true>"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(KERNEL))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, cell, trace):
    p = subprocess.run([sys.executable, "-m", "psabench.run", "--workload",
                        cell, "--seed", "2718281828", "--seconds", "5",
                        "--trace", str(trace)], cwd=REPO, text=True,
                       capture_output=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    want = {registry.metric_name(m) for m in registry.metrics()
            if m.KIND == kind and cell in getattr(m, "WORKLOADS", (cell,))}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        ops = [name for name, _ in res["breakdown"]["device_ops"]]
        assert any(KERNEL[cell] in name for name in ops), ops
