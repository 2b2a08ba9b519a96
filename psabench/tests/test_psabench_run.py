"""A run of the harness on the CPU: it refuses to measure without a card,
and, with the card's look skipped, it checks what the timed path produced:
a sound program comes out correct, and a program broken underneath in each
way these cells can be broken comes out not correct."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from psabench import registry, run

REPO = Path(__file__).resolve().parents[2]
CELLS = ("single.long_seq2", "batch.long_rows")


def run_small(cell, small_mix, seed=123456789012):
    return run.run_cell(registry.cell(cell), seed, 0.3, False,
                        torch.device("cpu"), time.perf_counter(), small_mix,
                        log=lambda line: None)


def test_measuring_without_a_card_fails_and_prints_no_result(monkeypatch,
                                                            capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "single.long_seq2", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_too_few_cards_fail(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "batch.long_rows", "--seed", "1",
                   "--seconds", "1", "--trace", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and psabench/: no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "psabench", tmp_path / "psabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "from psabench import run; sys.exit(run.main(sys.argv[1:]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code, "--workload",
                        "single.long_seq2", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "No result" in p.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, small_mix):
    res = run_small(cell, small_mix)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["wrong_answers"] == {"value": 0, "limit": 0}
    assert set(res["metrics"]) == {"pair_evals_per_s", "request_ms_p95",
                                   "setup_s"}
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_span_metrics(cell, small_mix):
    res = run.run_cell(registry.cell(cell), 5, 2.5, True, torch.device("cpu"),
                       time.perf_counter(), small_mix, log=lambda line: None)
    assert res["correct"] is True
    # on the CPU the spans read; the device metrics find nothing to read
    assert {"front_ms", "host_select_ms"} <= set(res["metrics"])
    assert not {"kernels_roofline", "copy_ms", "epilogue_us"} & set(res["metrics"])
    assert "busy_s" in res["device"] and "breakdown" in res


def _alter(r):
    return None if r is None else dataclasses.replace(r, offset=r.offset + 1)


def altered_single(monkeypatch):
    """An answer altered where it is produced: host selection's winner."""
    from psa_torch.models import batch

    orig = batch.host_select
    monkeypatch.setattr(batch, "host_select",
                        lambda *a, **k: _alter(orig(*a, **k)))


def altered_batch(monkeypatch):
    from psa_torch.models import batch

    orig = batch._host_select

    def one_altered(*a, **k):
        out = orig(*a, **k)
        return [_alter(out[0])] + out[1:]
    monkeypatch.setattr(batch, "_host_select", one_altered)


def half_left_out(monkeypatch):
    """Half of the batch left out: the second half's queries get no answer."""
    from psa_torch.models import batch

    orig = batch._host_select

    def half(*a, **k):
        out = orig(*a, **k)
        n = len(out) // 2
        return out[: len(out) - n] + [None] * n
    monkeypatch.setattr(batch, "_host_select", half)


def stale_single(monkeypatch):
    """State returned unchanged: every call answers what the first did."""
    from psa_torch.models.search import AlignmentSearchEngine

    orig, first = AlignmentSearchEngine.search, []

    def stale(self, *a, **k):
        if not first:
            first.append(orig(self, *a, **k))
        return first[0]
    monkeypatch.setattr(AlignmentSearchEngine, "search", stale)


def stale_batch(monkeypatch):
    from psa_torch.models import batch

    orig, first = batch.search_batch, []

    def stale(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0]
    monkeypatch.setattr(batch, "search_batch", stale)


# the faults each cell can have; neither has an exchange between chips
FAULTS = [("single.long_seq2", altered_single),
          ("single.long_seq2", stale_single),
          ("batch.long_rows", altered_batch),
          ("batch.long_rows", half_left_out),
          ("batch.long_rows", stale_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_program_comes_out_not_correct(cell, fault, small_mix,
                                                monkeypatch):
    fault(monkeypatch)
    res = run_small(cell, small_mix)
    assert res["correct"] is False
    n = res["checks"]
    assert n["wrong_answers"]["value"] > 0 or n["failed_requests"]["value"] > 0


def test_a_failing_request_is_counted_and_not_correct(small_mix, monkeypatch):
    from psa_torch.models.search import AlignmentSearchEngine

    def boom(self, *a, **k):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(AlignmentSearchEngine, "search", boom)
    cell = registry.cell("single.long_seq2")
    with pytest.raises(RuntimeError):   # the warm-up's call raises first
        run.run_cell(cell, 1, 0.2, False, torch.device("cpu"),
                     time.perf_counter(), small_mix, log=lambda line: None)


def test_a_request_failing_in_the_window_is_counted(small_mix, monkeypatch):
    from psa_torch.models.search import AlignmentSearchEngine

    orig, calls = AlignmentSearchEngine.search, []

    def flaky(self, *a, **k):
        calls.append(1)
        if len(calls) == 3:     # the window's first request (warm-up: 2)
            raise RuntimeError("launch failed")
        return orig(self, *a, **k)
    monkeypatch.setattr(AlignmentSearchEngine, "search", flaky)
    res = run_small("single.long_seq2", small_mix)
    assert res["correct"] is False and res["failed"] == 1
    assert res["checks"]["failed_requests"]["value"] == 1
