"""The serve warm start (`psa-torch --serve --warmup FILE --warmup-sizes
SPEC`) against the JAX package's `_serve_warmup`.

Both packages' warmups run with their warm functions replaced by recorders
(the JAX package's `planned_runner_keys` wrapped, its `warm_fused_runner`
and the port's `warm_fused_runner` and `warm_kernels` recorded), so no
Pallas compile and no chunk runs.  From the same warmup files they must
put the same lines in one bucket, detect the same shared-Seq1 buckets,
warm the same batch sizes, skip the same lines with the same warnings and
exit the same way on a bad file or spec.  A bucket's key is each
package's own (the port's `bucket_shape`, the JAX package's `plan_shapes`),
so the files' shapes are ones both split alike.  The JAX package warms
one weight vector per (mode, shape) key; the port warms every one.

Then the warmup for real, on the plain versions of the kernels: replies
byte-equal to `psa --serve --backend numpy` on stdin and TCP, in text and
JSON, the `[warmup]` lines before the listening line, a failed warmup that
exits 1 before any reply, host backends that touch no device path, and
`warm_fused_runner` itself."""

import io
import json
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from psa_tpu.models import batch as jax_batch
from psa_tpu.utils import cli as jax_cli
from psa_tpu.utils import server as jax_server

from psa_torch import native
from psa_torch.core.tables import build_tables_cached, device_tables_cached
from psa_torch.models import batch
from psa_torch.ops.sweep import bucket_shape, plan_bucket
from psa_torch.utils import cli, server
from psa_torch.utils.generator import random_sequences

ROOT = Path(__file__).resolve().parent.parent


def qline(seed, n1=600, n2=100, weights="1 3 4 2", mode="minimum", s1=None):
    a, b = random_sequences(n1, n2, seed=seed)
    return f"{weights} {s1 or a} {b} {mode}"


SHARED_S1 = random_sequences(900, 1, seed=99)[0]
PARTLY_S1 = random_sequences(3000, 1, seed=98)[0]

FILES = {
    # per-row, shared-Seq1, partly shared, another weight vector on the
    # first bucket's shape, the other mode, and lines to skip
    "mixed": [qline(1), qline(2), qline(3),
              qline(4, 900, 60, "2 1 1 5", "maximum", SHARED_S1),
              qline(5, 900, 60, "2 1 1 5", "maximum", SHARED_S1),
              "not a query", "",
              qline(6, 3000, 100, s1=PARTLY_S1), qline(7, 3000, 100, s1=PARTLY_S1),
              qline(8, 3000, 100),
              qline(9, weights="1.5 3 4 2"), qline(10, mode="maximum"),
              "1 3 4 2 abcdefgh cde minimum", "nan 3 4 2 ABCD AB minimum",
              "1 3 4 2 AB ABCD minimum", "   ",
              qline(11, 900, 60, "2 1 1 5", "maximum", SHARED_S1)],
    "one_line": [qline(20)],
    "all_shared": [qline(30 + s, 900, 60, s1=SHARED_S1) for s in range(4)],
    "nothing_valid": ["bad", "", "1 3 4 2 AB ABC minimum"],
}

SPECS = [("chunk", 256), ("chunk", 4), ("ladder", 8), ("ladder", 6), ("64,256", 256),
         ("0,64,4096", 256), ("3, 5,", 256), (" 7 ", 256)]


def _write(tmp_path, lines, name="warm.txt") -> str:
    f = tmp_path / name
    f.write_text("\n".join(lines) + "\n")
    return str(f)


def jax_warmup(monkeypatch, capsys, path, spec="chunk", serve_batch=256, extra=()):
    """The JAX package's _serve_warmup with recorders -> (rc, planned,
    warmed, stderr): planned = (weights, is_max, l1k, l2p, b, shared) of
    each planned_runner_keys call, warmed = the same of each warm call."""
    planned, warmed = [], []
    real_keys = jax_batch.planned_runner_keys

    def keys(tables, b_n, l1k, l2p, **kw):
        planned.append((tuple(tables.weights), tables.is_max, l1k, l2p, b_n,
                        bool(kw.get("shared_s1")) and b_n > 1))
        return real_keys(tables, b_n, l1k, l2p, **kw)

    def warm(tables, b, l1k, l2p, mesh=None, shared_s1=False, **kw):
        warmed.append((tuple(tables.weights), tables.is_max, l1k, l2p, b, shared_s1))

    monkeypatch.setattr(jax_batch, "planned_runner_keys", keys)
    monkeypatch.setattr(jax_batch, "warm_fused_runner", warm)
    args = jax_cli.build_parser().parse_args(
        ["--serve", "--warmup", path, "--warmup-sizes", spec,
         "--serve-batch", str(serve_batch), *extra])
    capsys.readouterr()
    rc = jax_cli._serve_warmup(args, None)
    return rc, planned, warmed, capsys.readouterr().err


def port_warmup(monkeypatch, capsys, path, spec="chunk", serve_batch=256, extra=()):
    """The port's _serve_warmup with recorders -> (rc, warmed, kernels,
    stderr)."""
    warmed, kernels = [], []

    def warm(tables, b, l1k, l2p, device, mesh=None, shared_s1=False, finish=None):
        warmed.append((tuple(tables.weights), tables.is_max, l1k, l2p, b, shared_s1))

    monkeypatch.setattr(batch, "warm_fused_runner", warm)
    monkeypatch.setattr(batch, "warm_kernels",
                        lambda tables, device, mesh=None, finish=None:
                        kernels.append(device))
    args = cli.build_parser().parse_args(
        ["--serve", "--device", "cpu", "--warmup", path, "--warmup-sizes", spec,
         "--serve-batch", str(serve_batch), *extra])
    assert cli._fold_device_share(args) is None
    capsys.readouterr()
    rc = cli._serve_warmup(args, torch.device("cpu"), None)
    return rc, warmed, kernels, capsys.readouterr().err


def _bucket_of_each_line(run, lines, tmp_path) -> dict:
    """{line index: the bucket key `run` warms for that line alone}."""
    out = {}
    for j, ln in enumerate(lines):
        calls = run(_write(tmp_path, [ln], f"line_{j}.txt"))
        keys = {c[:4] for c in calls}
        assert len(keys) <= 1
        if keys:
            out[j] = keys.pop()
    return out


def _partition(bucket_of: dict) -> set:
    groups: dict = {}
    for j, key in bucket_of.items():
        groups.setdefault(key, set()).add(j)
    return {frozenset(g) for g in groups.values()}


def _plan(calls, bucket_of) -> dict:
    """{frozenset of line indices: sorted distinct (b, shared) warmed}."""
    lines_of: dict = {}
    for j, key in bucket_of.items():
        lines_of.setdefault(key, set()).add(j)
    plan: dict = {}
    for c in calls:
        plan.setdefault(frozenset(lines_of[c[:4]]), set()).add(c[4:])
    return {k: sorted(v) for k, v in plan.items()}


def _warnings(err: str) -> list:
    return [ln for ln in err.splitlines() if ln.startswith("warning:")]


@pytest.mark.parametrize("spec,serve_batch", SPECS)
@pytest.mark.parametrize("name", sorted(FILES))
def test_buckets_sizes_and_warnings_equal_the_jax_package(monkeypatch, capsys, tmp_path,
                                                          name, spec, serve_batch):
    lines = FILES[name]
    path = _write(tmp_path, lines)
    rc_j, planned_j, _, err_j = jax_warmup(monkeypatch, capsys, path, spec, serve_batch)
    rc_p, warmed_p, kernels, err_p = port_warmup(monkeypatch, capsys, path, spec,
                                                 serve_batch)
    assert rc_j == rc_p == 0
    assert _warnings(err_p) == _warnings(err_j)
    assert len(warmed_p) == len(set(warmed_p))          # nothing warmed twice
    assert kernels == ([torch.device("cpu")] if warmed_p else [])

    def jax_run(p):
        return jax_warmup(monkeypatch, capsys, p, spec, serve_batch)[1]

    def port_run(p):
        return port_warmup(monkeypatch, capsys, p, spec, serve_batch)[1]

    bucket_j = _bucket_of_each_line(jax_run, lines, tmp_path)
    bucket_p = _bucket_of_each_line(port_run, lines, tmp_path)
    assert set(bucket_p) == set(bucket_j)               # the same lines skipped
    assert _partition(bucket_p) == _partition(bucket_j)
    # per bucket of lines: the same batch sizes, each plain and, for a
    # shared-Seq1 bucket, on the shared kernel
    assert _plan(warmed_p, bucket_p) == _plan(planned_j, bucket_j)


def test_the_mixed_file_exercises_every_rule(monkeypatch, capsys, tmp_path):
    """What the comparison above covers on the mixed file: 5 buckets (one
    of them shared-Seq1, one partly shared, two of one shape and mode),
    4 lines skipped with a warning and 2 blank ones, and a ladder of 4
    sizes."""
    path = _write(tmp_path, FILES["mixed"])
    rc, warmed, kernels, err = port_warmup(monkeypatch, capsys, path, "ladder", 8)
    assert rc == 0 and len(kernels) == 1
    assert len({c[:4] for c in warmed}) == 5
    shared = {c[:4] for c in warmed if c[5]}
    assert [k[0] for k in shared] == [(2.0, 1.0, 1.0, 5.0)]
    assert len(_warnings(err)) == 4
    assert sorted({c[4] for c in warmed}) == [1, 2, 4, 8]
    assert sum(ln.startswith("[warmup] bucket ") for ln in err.splitlines()) == len(warmed)


def test_every_weight_vector_is_warmed(monkeypatch, capsys, tmp_path):
    """The one planned divergence: the JAX package warms a (mode, shape)
    key once, whatever the weights (its runners are weights-generic); the
    port's device tables are per weights, so it warms each weight vector."""
    lines = [qline(1), qline(2, weights="1.5 3 4 2"), qline(3, weights="2 2 2 2"),
             qline(4, mode="maximum")]
    path = _write(tmp_path, lines)
    _, planned, warmed_j, _ = jax_warmup(monkeypatch, capsys, path, "64,256")
    _, warmed_p, _, _ = port_warmup(monkeypatch, capsys, path, "64,256")
    assert len(warmed_j) == 4                       # (min, max) x (64, 256)
    assert len(planned) == len(warmed_p) == 8       # 4 weight vectors x 2 sizes
    assert {c[:2] for c in warmed_p} == {c[:2] for c in planned}


@pytest.mark.parametrize("case", ["missing_file", "bad_spec", "bad_spec_word",
                                  "bad_spec_after_warnings"])
def test_exit_codes_equal_the_jax_package(monkeypatch, capsys, tmp_path, case):
    path = str(tmp_path / "absent.txt") if case == "missing_file" else _write(
        tmp_path, ["bad line", qline(1)] if case.endswith("warnings") else [qline(1)])
    spec = {"missing_file": "chunk", "bad_spec": "4,banana",
            "bad_spec_word": "everything"}.get(case, "1,,x")
    rc_j, _, warmed_j, err_j = jax_warmup(monkeypatch, capsys, path, spec)
    rc_p, warmed_p, kernels, err_p = port_warmup(monkeypatch, capsys, path, spec)
    assert rc_j == rc_p == 2
    assert err_p == err_j
    assert err_p.splitlines()[-1].startswith("error: ")
    assert warmed_j == warmed_p == kernels == []


def test_cli_warmup_errors_exit_2_before_serving(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(sys, "stdin", io.StringIO(qline(1) + "\n"))
    assert cli.main(["--serve", "--quiet", "--device", "cpu",
                     "--warmup", str(tmp_path / "absent.txt")]) == 2
    assert "cannot read --warmup" in capsys.readouterr().err
    assert cli.main(["--serve", "--quiet", "--device", "cpu", "--warmup",
                     _write(tmp_path, [qline(1)]), "--warmup-sizes", "4,banana"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "bad --warmup-sizes" in err
    assert sys.stdin.tell() == 0


# --- the warmup for real, on the plain versions of the kernels --------------

SERVED = [qline(1), "bad", qline(40, 900, 60, "2 1 1 5", "maximum", SHARED_S1),
          qline(41, 900, 60, "2 1 1 5", "maximum", SHARED_S1), "",
          qline(42, 1200, 90), "1 3 4 2 ABCj AB minimum", qline(9, weights="1.5 3 4 2")]
WARM = [qline(2), qline(3, weights="1.5 3 4 2"),
        qline(43, 900, 60, "2 1 1 5", "maximum", SHARED_S1),
        qline(44, 900, 60, "2 1 1 5", "maximum", SHARED_S1), "skip me"]


def jax_replies(lines, json_out):
    return [r for r in jax_server.process_query_lines(
        lines, backend="numpy", lenient=False, json_out=json_out, mesh=None)[0]
        if r is not None]


def _counting(monkeypatch, name):
    calls = []
    real = getattr(batch, name)
    monkeypatch.setattr(batch, name,
                        lambda *a, **k: calls.append(k.get("shared_s1")) or real(*a, **k))
    return calls


@pytest.mark.parametrize("extra", [[], ["--json"], ["--warmup-sizes", "ladder",
                                                    "--serve-batch", "4"]])
def test_stdin_serve_with_warmup_equals_the_jax_package(monkeypatch, capsys, tmp_path,
                                                         extra):
    text = "\n".join(SERVED) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert jax_cli.main(["--serve", "--quiet", "--backend", "numpy", *extra]) == 0
    want = capsys.readouterr().out
    warms = _counting(monkeypatch, "warm_fused_runner")
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert cli.main(["--serve", "--device", "cpu", "--warmup",
                     _write(tmp_path, WARM), *extra]) == 0
    out, err = capsys.readouterr()
    assert out == want
    assert len(want.splitlines()) == 7
    # 3 buckets, the shared one also on the shared kernel, and warm_kernels'
    # two small chunks
    n_sizes = 3 if "ladder" in extra else 1
    shared_sizes = 2 if "ladder" in extra else 1
    assert len(warms) == 2 + 3 * n_sizes + shared_sizes
    assert warms.count(True) == 1 + shared_sizes
    log = err.splitlines()
    assert log[0] == "warning: --warmup line 5 skipped: input needs >= 7 " \
                     "whitespace-delimited tokens, got 2"
    assert log[1].startswith("[warmup] kernels ")
    served = next(i for i, ln in enumerate(log) if ln.startswith("[serve] "))
    assert all(ln.startswith("[warmup] ") for ln in log[1:served])
    assert log[served - 1].startswith("[warmup] 3 bucket(s) warmed in ")


class _Server:
    """`psa-torch --serve --listen 127.0.0.1:0 ...` as a subprocess; its
    stderr up to the listening line is kept."""

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "psa_torch.utils.cli", "--serve", "--listen",
             "127.0.0.1:0", *args], cwd=ROOT, stderr=subprocess.PIPE, text=True)
        self.before = []
        for line in self.proc.stderr:
            if "listening on" in line:
                self.port = int(line.rsplit(":", 1)[1])
                return
            self.before.append(line.rstrip("\n"))
        raise AssertionError(f"no listening line: {self.before}")

    def roundtrip(self, lines) -> list:
        with socket.create_connection(("127.0.0.1", self.port), timeout=60) as s:
            s.sendall(("\n".join(lines) + "\n").encode())
            s.shutdown(socket.SHUT_WR)
            buf = b""
            while data := s.recv(1 << 16):
                buf += data
        return buf.decode().splitlines()

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=60)
        finally:
            self.proc.stderr.close()


@pytest.mark.parametrize("json_out", [False, True])
def test_listen_with_warmup_equals_the_jax_package(tmp_path, json_out):
    srv = _Server("--device", "cpu", "--warmup", _write(tmp_path, WARM),
                  *(["--json"] if json_out else []))
    try:
        got = srv.roundtrip(SERVED)
    finally:
        rc = srv.stop()
    assert rc == 0
    assert got == jax_replies(SERVED, json_out)
    if json_out:
        assert all(isinstance(json.loads(r), dict) for r in got)
    # every [warmup] line comes before the listening line
    assert srv.before[0].startswith("warning: --warmup line 5 skipped")
    assert [ln.split()[1] for ln in srv.before[1:]] == ["kernels"] + ["bucket"] * 4 + ["3"]


@pytest.mark.parametrize("listen", [False, True])
def test_warm_chunks_finish_on_the_serve_loops_thread(monkeypatch, capsys, tmp_path,
                                                      listen):
    """The serve loop's finishing thread is made before the warmup, whose
    chunks are dispatched on this thread and finished on that one, as the
    clients' chunks are; the loop then keeps it."""
    made, selected_on = [], []
    real_fin, real_select = server.Finisher, batch._host_select

    class Finisher(real_fin):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(server, "Finisher", Finisher)
    monkeypatch.setattr(batch, "_host_select", lambda *a, **k: selected_on.append(
        threading.current_thread().name) or real_select(*a, **k))
    path = _write(tmp_path, WARM)
    if listen:
        real_run = server.TCPQueryServer.run

        def run_and_stop(self):
            assert self._given_fin is made[0]
            self.request_stop()             # listen, then stop at once
            return real_run(self)

        monkeypatch.setattr(server.TCPQueryServer, "run", run_and_stop)
        assert cli.main(["--serve", "--quiet", "--device", "cpu", "--warmup", path,
                         "--listen", "127.0.0.1:0"]) == 0
        assert "listening on" in capsys.readouterr().err
        n_warm = 6
    else:
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(SERVED) + "\n"))
        assert cli.main(["--serve", "--quiet", "--device", "cpu", "--warmup", path]) == 0
        assert capsys.readouterr().out.splitlines() == jax_replies(SERVED, False)
        n_warm = 6
    assert len(made) == 1
    assert len(selected_on) > n_warm - 1 and set(selected_on) == {"psa-finisher"}
    assert not made[0]._t.is_alive()


@pytest.mark.parametrize("listen", [False, True])
def test_failed_warmup_exits_1_before_serving(monkeypatch, capsys, tmp_path, listen):
    """A warmup whose dispatch raises ends the process with exit 1 and an
    `error:` line: no reply, no listening line, no host engine."""
    def dispatch_fails(*a, **k):
        raise RuntimeError("sweep_batched launch failed (simulated)")

    monkeypatch.setattr(batch, "batched_search_exact_async", dispatch_fails)
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(SERVED) + "\n"))
    before = native.calls["search"]
    argv = ["--serve", "--device", "cpu", "--warmup", _write(tmp_path, WARM)]
    assert cli.main(argv + (["--listen", "127.0.0.1:0"] if listen else [])) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "error: warmup failed: RuntimeError: sweep_batched launch failed" in err
    assert "listening" not in err and "[serve]" not in err
    assert native.calls["search"] == before
    assert sys.stdin.tell() == 0


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_host_backend_warmup_touches_no_device_path(monkeypatch, capsys, tmp_path,
                                                    backend):
    """With a host backend the warm runs a chunk of that backend: without a
    card, and with the device dispatch made to fail, it still warms and
    serves the JAX package's replies."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_device(*a, **k):
        raise AssertionError("the device path ran")

    monkeypatch.setattr(batch, "batched_search_exact_async", no_device)
    monkeypatch.setattr(batch, "warm_kernels", no_device)
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(SERVED) + "\n"))
    before = native.calls["search"]
    assert cli.main(["--serve", "--backend", backend, "--warmup",
                     _write(tmp_path, WARM), "--serve-batch", "2"]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines() == jax_replies(SERVED, False)
    assert sum(ln.startswith("[warmup] bucket ") for ln in err.splitlines()) == 4
    # 3 buckets of 2 dummy queries, one twice, then 5 queries
    assert native.calls["search"] - before == (8 + 5 if backend == "native" else 0)


# --- warm_fused_runner ------------------------------------------------------

@pytest.mark.parametrize("n1,n2,b,shared", [(600, 100, 3, False), (2048, 512, 4, True),
                                            (5000, 33, 1, True)])
def test_warm_rows_fill_their_bucket(n1, n2, b, shared):
    l1k, l2p = bucket_shape(n1, n2)
    c1b, c2b, noffs, n2s = batch.warm_rows(b, l1k, l2p, shared)
    assert c1b.shape == (b, l1k) and c2b.shape == (b, l2p)
    assert (noffs == l1k - l2p).all() and (n2s == l2p).all()
    n1w = int(noffs[0] + n2s[0] - 1)
    assert bucket_shape(n1w, int(n2s[0])) == (l1k, l2p)
    assert plan_bucket(noffs, l2p) == (l1k - l2p, l1k)     # no tighter padding
    assert (c1b[:, :n1w] < 26).all() and (c2b < 26).all() and (c1b[:, n1w:] == 28).all()
    assert (c1b == c1b[:1]).all() == (shared or b == 1)


@pytest.mark.parametrize("shared", [False, True])
def test_warm_fused_runner_takes_the_serve_dispatch(monkeypatch, shared):
    """One chunk through batched_search_exact_async on the cached device
    tables, which the next serve chunk of those weights reads."""
    tables = build_tables_cached(np.array([1.25, 3.0, 4.0, 2.0]), False)
    l1k, l2p = bucket_shape(600, 100)
    seen = []
    real = batch.batched_search_exact_async

    def spy(c1b, c2b, noffs, n2s, dtabs, **kw):
        seen.append((c1b.shape, dtabs, kw.get("shared_s1")))
        return real(c1b, c2b, noffs, n2s, dtabs, **kw)

    monkeypatch.setattr(batch, "batched_search_exact_async", spy)
    batch.warm_fused_runner(tables, 3, l1k, l2p, "cpu", shared_s1=shared)
    dtabs = device_tables_cached(tables, torch.device("cpu"))
    assert seen == [((3, l1k), dtabs, shared)]
    from psa_torch.utils.server import process_query_lines

    lines = [qline(s, weights="1.25 3 4 2") for s in (50, 51)]
    got = process_query_lines(lines, backend="torch", lenient=False, json_out=False,
                              device="cpu")[0]
    assert seen[1][1] is dtabs
    assert got == jax_replies(lines, False)


def test_warm_fused_runner_on_a_mesh(monkeypatch):
    tables = build_tables_cached(np.array([1.0, 3.0, 4.0, 2.0]), True)
    l1k, l2p = bucket_shape(600, 100)
    seen = []
    real = batch.batched_search_exact_sharded_async
    monkeypatch.setattr(batch, "batched_search_exact_sharded_async",
                        lambda *a, **k: seen.append((a[0].shape, len(a[5]))) or real(*a, **k))
    batch.warm_fused_runner(tables, 5, l1k, l2p, None, mesh=["cpu"] * 3)
    assert seen == [((5, l1k), 3)]


def test_warm_kernels_launch_both_sweeps_on_every_mesh_device(monkeypatch):
    calls = []
    monkeypatch.setattr(batch, "warm_fused_runner",
                        lambda t, b, l1k, l2p, device, mesh=None, shared_s1=False,
                        finish=None: calls.append((b, l1k, l2p, shared_s1)))
    tables = build_tables_cached(np.array([1.0, 3.0, 4.0, 2.0]), False)
    batch.warm_kernels(tables, "cpu")
    batch.warm_kernels(tables, None, ["cpu"] * 3)
    l1k, l2p = bucket_shape(1, 1)
    assert calls == [(1, l1k, l2p, False), (2, l1k, l2p, True),
                     (3, l1k, l2p, False), (3, l1k, l2p, True)]
