"""`psa_torch.utils.profiling` and `psa-torch --trace` on the CPU, against
the JAX package's CLI; and the small helpers and package exports of this
slice against the JAX package's."""

import glob
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import psa_tpu
from psa_tpu.core import tables as jtables
from psa_tpu.core.result import SearchResult as JaxResult
from psa_tpu.utils import cli as jax_cli
from psa_tpu.utils import generator as jgenerator

import psa_torch
from psa_torch.core import tables
from psa_torch.core.result import SearchResult
from psa_torch.utils import cli, generator, profiling
from psa_torch.utils.generator import random_sequences, write_input_file

ROOT = Path(__file__).resolve().parent.parent


def trace_events(logdir) -> list:
    files = glob.glob(os.path.join(str(logdir), "*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(Path(files[0]).read_text())["traceEvents"]


def test_trace_without_logdir_does_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    for logdir in (None, ""):
        with profiling.trace(logdir):
            x = torch.ones(3).sum()
    assert float(x) == 3.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), cuda=False):
        torch.nn.functional.conv1d(torch.ones(1, 2, 30), torch.ones(3, 2, 5))
    names = {e.get("name") for e in trace_events(tmp_path / "tr")}
    assert "aten::conv1d" in names


def test_cli_trace_single_query_names_the_engines_ops(tmp_path, capsys):
    s1, s2 = random_sequences(3000, 400, seed=2)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), (1.0, 3.0, 4.0, 2.0), s1, s2, False)
    plain, ref = tmp_path / "plain.txt", tmp_path / "ref.txt"
    assert jax_cli.main([str(inp), "-o", str(ref), "--backend", "numpy",
                         "--quiet"]) == 0
    for backend, op in (("conv", "aten::conv1d"), ("xla", "aten::index"),
                        ("torch", "aten::index")):
        out = tmp_path / f"{backend}.txt"
        logdir = tmp_path / f"trace_{backend}"
        assert cli.main([str(inp), "-o", str(out), "--backend", backend,
                         "--device", "cpu", "--quiet", "--trace", str(logdir)]) == 0
        assert cli.main([str(inp), "-o", str(plain), "--backend", backend,
                         "--device", "cpu", "--quiet"]) == 0
        assert out.read_bytes() == plain.read_bytes() == ref.read_bytes()
        assert op in {e.get("name") for e in trace_events(logdir)}, backend


def test_cli_trace_batch(tmp_path, capsys):
    cases = tmp_path / "cases.txt"
    assert generator.main(["700", "120", "--cases", "3", "-o", str(cases)]) == 0
    for backend in ("torch", "conv"):
        traced, plain = tmp_path / f"t_{backend}", tmp_path / f"p_{backend}"
        assert cli.main([str(cases), "--batch", "--backend", backend, "--device",
                         "cpu", "--quiet", "-o", str(traced), "--trace",
                         str(tmp_path / f"tr_{backend}")]) == 0
        assert cli.main([str(cases), "--batch", "--backend", backend, "--device",
                         "cpu", "--quiet", "-o", str(plain)]) == 0
        for f in sorted(plain.iterdir()):
            assert (traced / f.name).read_bytes() == f.read_bytes()
        names = {e.get("name") for e in trace_events(tmp_path / f"tr_{backend}")}
        assert "aten::conv1d" in names if backend == "conv" else "aten::index" in names


def test_cli_trace_serve(tmp_path, monkeypatch, capsys):
    lines = "".join(f"1 3 4 2 {a} {b} {'maximum' if i % 2 else 'minimum'}\n"
                    for i, (a, b) in enumerate(random_sequences(400 + 50 * i, 60, seed=i)
                                               for i in range(5)))
    outs = []
    for extra in (["--trace", str(tmp_path / "tr")], []):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines + "bad line\n"))
        assert cli.main(["--serve", "--quiet", "--device", "cpu", *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) == 6 and outs[0].splitlines()[-1].startswith("error")
    assert "aten::index" in {e.get("name") for e in trace_events(tmp_path / "tr")}


def test_no_profiler_without_trace(tmp_path):
    """Without --trace the CLI neither imports utils/profiling nor starts a
    profiler."""
    s1, s2 = random_sequences(800, 90, seed=4)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), (1.0, 3.0, 4.0, 2.0), s1, s2, True)
    code = ("import sys, torch, torch.profiler\n"
            "def refuse(*a, **k):\n"
            "    raise SystemExit('a profiler was started')\n"
            "torch.profiler.profile = refuse\n"
            "from psa_torch.utils import cli\n"
            f"rc = cli.main([{str(inp)!r}, '-o', {str(tmp_path / 'o.txt')!r}, "
            "'--device', 'cpu', '--backend', 'conv', '--quiet'])\n"
            "print(rc, 'psa_torch.utils.profiling' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "False"]


def test_package_exports_match_jax():
    assert psa_torch.__all__ == psa_tpu.__all__
    s = "ABCXYZ-HELLO"
    np.testing.assert_array_equal(psa_torch.encode(s), psa_tpu.encode(s))
    assert psa_torch.decode(psa_torch.encode(s)) == psa_tpu.decode(psa_tpu.encode(s)) == s
    mine = psa_torch.build_tables([1.0, 3.0, 4.0, 2.0], True)
    theirs = psa_tpu.build_tables([1.0, 3.0, 4.0, 2.0], True)
    assert isinstance(mine, psa_torch.ScoringTables)
    np.testing.assert_array_equal(mine.code, theirs.code)
    q = psa_torch.Query(np.array([1.0, 3.0, 4.0, 2.0]), "ABCDEFGHIJ", "ABC", False)
    jq = psa_tpu.Query(np.array([1.0, 3.0, 4.0, 2.0]), "ABCDEFGHIJ", "ABC", False)
    got = psa_torch.search_batch([q, q], backend="numpy")
    want = psa_tpu.search_batch([jq, jq], backend="numpy")
    assert [(r.offset, r.char_offset, r.sub_code, r.score) for r in got] == [
        (r.offset, r.char_offset, r.sub_code, r.score) for r in want]


def test_lazy_search_batch_loads_the_batch_module_only_when_called():
    code = ("import sys, psa_torch; a = 'psa_torch.models.batch' in sys.modules; "
            "psa_torch.search_batch([], device='cpu'); "
            "print(a, 'psa_torch.models.batch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True"]


def test_mutant_codes_match_jax():
    rng = np.random.default_rng(6)
    codes2 = rng.integers(0, 27, 40).astype(np.int32)
    for off, coff, sub in ((0, 0, 5), (12, 39, 26), (3, 17, 0)):
        mine = SearchResult(off, coff, sub, -3.5)
        theirs = JaxResult(off, coff, sub, -3.5)
        np.testing.assert_array_equal(mine.mutant_codes(codes2),
                                      theirs.mutant_codes(codes2))
        assert mine.mutant_from_codes(codes2) == theirs.mutant_from_codes(codes2)
    assert codes2[17] == codes2.copy()[17]          # the input is not changed


def test_pair_sign_matches_jax():
    assert all(tables.pair_sign(a, b) == jtables.pair_sign(a, b)
               for a in range(29) for b in range(29))


@pytest.mark.parametrize("args", [(1000, 100, 0), (5000, 300, 7, (2.0, 1.0, 5.0, 0.5), True)])
def test_make_workload_matches_jax(args):
    mine = generator.make_workload(*args)
    theirs = jgenerator.make_workload(*args)
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert mine[0].dtype == theirs[0].dtype
    assert mine[1:] == theirs[1:]
