"""The harness finds cells, mixes, drivers and metrics by name, BENCHMARK.json
lists the same, and a later cell, traffic kind and metric are added as new
files with no file that is there edited."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from psabench import registry

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_benchmark_json_has_the_contracts_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["psabench"]
    assert BENCH["command"] == ["python3", "-m", "psabench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines_keep_their_limits():
    items = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    names = [i["name"] for i in items]
    assert all(NAME.fullmatch(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [i["name"] for i in BENCH[group]]
        assert len(group_names) == len(set(group_names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([i["why"] for i in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_workload_is_a_cell_file(w):
    cell = registry.cell(w["name"])
    assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == {
        k: w[k] for k in ("config", "traffic", "chips", "why")}
    registry.config(w["config"])
    mix = registry.traffic(w["traffic"])
    registry.driver(mix["kind"])
    assert w["chips"] == 1


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"psabench/configs/{c['name']}.json"
        assert (REPO / c["file"]).is_file()
        assert c["source"].startswith("https://")


def test_metric_modules_match_benchmark_json():
    mods = {registry.metric_name(m): m for m in registry.metrics()}
    declared = BENCH["end_to_end"] + BENCH["per_layer"]
    assert set(mods) == {m["name"] for m in declared}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        mod = mods[m["name"]]
        assert (mod.KIND, mod.UNIT, mod.BETTER, mod.SOURCE) == (
            "end_to_end", m["unit"], m["better"], m["source"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        mod = mods[m["name"]]
        assert (mod.KIND, mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER,
                mod.MOVES) == ("per_layer", m["unit"], m["better"],
                               m["source"], m["layer"], m["moves"])
        assert list(mod.WORKLOADS) == m["workloads"]
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_setup_s_and_another_metric_in_every_cell():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        registry.cell("no.such_cell")
    with pytest.raises(ValueError):
        registry.cell("../BENCHMARK")
    with pytest.raises(ValueError):
        registry.driver("closed_loop.sub")


NEW_FILES = {
    "cells/extra.short.json": json.dumps({
        "config": "single_query", "traffic": "short_burst", "chips": 1,
        "why": "a cell added later"}),
    "traffic/short_burst.json": json.dumps({
        "kind": "burst_loop", "seq1_len": 700, "seq2_len": 90, "per_call": 1,
        "pool": 3}),
    "traffic/burst_loop.py": '''
"""A traffic kind added later: the closed loop with its own pool."""
from psabench.traffic.closed_loop import drive, pairs_per_call, warm  # noqa
from psabench.traffic import closed_loop

def make_pool(mix, seed):
    return closed_loop.make_pool(mix, seed + 1)
''',
    "metrics/requests_done.py": '''
"""A metric added later."""
KIND = "end_to_end"
UNIT = "requests"
BETTER = "higher"
SOURCE = "host_clock"
WORKLOADS = ("extra.short",)

def read(ctx):
    return len(ctx.requests)
''',
}


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_traffic_kind_and_metric_are_added_as_new_files(tmp_path):
    copy = tmp_path / "psabench"
    shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(copy)
    for rel, text in NEW_FILES.items():
        assert not (copy / rel).exists()
        (copy / rel).write_text(text)
    after = digest(copy)
    assert {k: after[k] for k in before} == before      # nothing edited
    code = """
import json, sys, time, torch
from psabench import registry, run
out = {}
for cell in ("extra.short", "single.long_seq2"):
    res = run.run_cell(registry.cell(cell), 9, 0.2, False, torch.device("cpu"),
                       time.perf_counter(), {"seq1_len": 700, "seq2_len": 90},
                       log=lambda line: None)
    out[cell] = [res["correct"], sorted(res["metrics"])]
print(json.dumps([registry.cells(), out]))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                       str(REPO)]))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       text=True, capture_output=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    cells, out = json.loads(p.stdout.strip().splitlines()[-1])
    assert "extra.short" in cells
    assert out["extra.short"] == [True, ["pair_evals_per_s", "request_ms_p95",
                                         "requests_done", "setup_s"]]
    # the new metric names its cell; the others are untouched
    assert out["single.long_seq2"] == [True, ["pair_evals_per_s",
                                              "request_ms_p95", "setup_s"]]
