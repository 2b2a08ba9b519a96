"""The port's serving tier (psa_torch.utils.server, `psa-torch --serve`)
against the JAX package's: the same chunks of query lines go through
`psa_tpu.utils.server.process_query_lines` on its numpy engine and through
the port's on the plain versions of the kernels (`backend="torch"`,
`device="cpu"`) and on the native host engine.  Replies are strings, so
every comparison is equality.  Also the stdin loop byte for byte against
`psa --serve`, the line reader, the exit codes, the start-up rule without
a card, and a device failure that must end the loop instead of being
answered by a host engine."""

import builtins
import io
import json
import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from psa_tpu.utils import cli as jax_cli
from psa_tpu.utils import server as jax_server

from psa_torch import native
from psa_torch.models import batch
from psa_torch.utils import cli, server
from psa_torch.utils.cli import _ServeLineReader
from psa_torch.utils.generator import random_sequences
from psa_torch.utils.io import Query

PORT_BACKENDS = [("torch", "cpu"), ("native", None)]


def qline(seed, n1=300, n2=40, weights="1 3 4 2", mode="minimum", s1=None):
    a, b = random_sequences(n1, n2, seed=seed)
    return f"{weights} {s1 or a} {b} {mode}"


TIES_S1, TIES_S2 = "AB" * 350, "AB" * 32

CHUNKS = {
    "order": [qline(s, 200 + 37 * s, 20 + 5 * s) for s in range(6)],
    "errors_mid_chunk": [qline(1), "not a query", "", qline(2),
                         "1 2 3 nonsense AB A minimum", "1 3 4 2 AB ABC minimum",
                         "   ", qline(3), "1 3 4 2 ABCD AB", qline(4)],
    "non_finite": ["nan 3 4 2 ABCD AB minimum", "1 1e999 4 2 ABCD AB maximum",
                   "inf 3 4 2 ABCD AB minimum", "1 3 -inf 2 ABCD AB minimum",
                   "nan 3 4 2 AB ABCD minimum", "1 3 4 -1e400 AB*D ab minimum",
                   qline(5)],
    "out_of_alphabet": ["1 3 4 2 ABCj AB minimum", "1 3 4 2 AB*CD XY maximum",
                        "1 3 4 2 abcdefgh cde minimum", qline(6),
                        "1 3 4 2 AB?CDEFG ?? minimum"],
    "mixed_modes_weights": [qline(7), qline(8, weights="2 1 1 5", mode="maximum"),
                            qline(9, 500, 90), qline(10, weights="0 0 0 0"),
                            qline(11, weights="-1 2.5 -3 4", mode="maximum"),
                            qline(12, mode="anything")],
    "shared_seq1": [qline(20 + s, 600, 50 + s, s1=random_sequences(600, 1, seed=99)[0])
                    for s in range(6)],
    "no_mutation": ["1 3 4 2 " + "?" * 60 + " " + "!" * 7 + " minimum",
                    "1 3 4 2 " + "?" * 60 + " " + "!" * 7 + " maximum", qline(13)],
    "ties_fallback": [f"1 3 4 2 {TIES_S1} {TIES_S2} minimum",
                      f"1 1 1 1 {TIES_S1} {TIES_S2} maximum", qline(14)],
}


def jax_replies(lines, lenient, json_out):
    return jax_server.process_query_lines(lines, backend="numpy", lenient=lenient,
                                          json_out=json_out, mesh=None)[0]


@pytest.mark.parametrize("json_out", [False, True])
@pytest.mark.parametrize("lenient", [False, True])
@pytest.mark.parametrize("backend,device", PORT_BACKENDS)
@pytest.mark.parametrize("case", sorted(CHUNKS))
def test_replies_equal_the_jax_package(case, backend, device, lenient, json_out):
    lines = CHUNKS[case]
    got, nq, _ = server.process_query_lines(lines, backend=backend, lenient=lenient,
                                            json_out=json_out, device=device)
    want = jax_replies(lines, lenient, json_out)
    assert got == want
    assert nq == sum(r is not None and not (r.startswith("error") or '"error"' in r)
                     for r in want)


def test_ties_take_the_near_gt_k_fallback(monkeypatch):
    """The tie-heavy chunk's 2-letter queries flood the f32 band past k, so
    host selection re-sweeps them from the finisher's side; the replies are
    still the JAX package's."""
    swept = []
    real = batch.offset_stats
    monkeypatch.setattr(batch, "offset_stats",
                        lambda *a, **k: swept.append(1) or real(*a, **k))
    lines = CHUNKS["ties_fallback"]
    got = server.process_query_lines(lines, backend="torch", lenient=False,
                                     json_out=False, device="cpu")[0]
    assert len(swept) == 2
    assert got == jax_replies(lines, False, False)


def test_auto_chunk_mixes_host_and_device_buckets(monkeypatch):
    """`auto` sends the small buckets of one chunk to the native engine and
    the large one to the device path; the replies are the JAX package's."""
    monkeypatch.setattr(batch.CONFIG, "auto_threshold", 50_000)
    lines = ([qline(30 + s, 200, 20) for s in range(3)]
             + [qline(40 + s, 1200, 100) for s in range(2)] + ["bad"])
    device_rows = []
    real = batch.batched_search_exact_async
    monkeypatch.setattr(batch, "batched_search_exact_async",
                        lambda c1b, *a, **k: device_rows.append(len(c1b))
                        or real(c1b, *a, **k))
    before = native.calls["search"]
    got = server.process_query_lines(lines, backend="auto", lenient=False,
                                     json_out=False, device="cpu")[0]
    assert got == jax_replies(lines, False, False)
    assert device_rows == [2]
    assert native.calls["search"] - before == 3


def test_dispatch_returns_before_finish_and_holds_the_fetches():
    """dispatch_query_lines enqueues the device buckets and returns; the
    pending chunk keeps the in-flight fetches until finish()."""
    lines = [qline(50), "bad", qline(51, 900, 100)]
    pending = server.dispatch_query_lines(lines, backend="torch", lenient=False,
                                          json_out=False, device="cpu")
    assert len(pending._handles) == 2
    assert all(isinstance(h, batch.Fetch) for h in pending._handles)
    outputs, nq, dt = pending.finish()
    assert nq == 2 and dt >= 0
    assert outputs == jax_replies(lines, False, False)


@pytest.mark.parametrize("extra", [[], ["--json"], ["--lenient"],
                                   ["--serve-batch", "2"]])
def test_stdin_serve_equals_the_jax_package_byte_for_byte(monkeypatch, capsys, extra):
    text = "\n".join(CHUNKS["errors_mid_chunk"] + CHUNKS["out_of_alphabet"]
                     + CHUNKS["no_mutation"] + CHUNKS["mixed_modes_weights"][:3])
    text += "\n" + qline(60)            # an unterminated last line
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert jax_cli.main(["--serve", "--quiet", "--backend", "numpy", *extra]) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert cli.main(["--serve", "--quiet", "--device", "cpu", *extra]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert len(want.splitlines()) == 20


class _PipeStream:
    """A stdin stand-in exposing a real pipe fd."""

    def __init__(self, fd):
        self._fd = fd

    def fileno(self):
        return self._fd


def test_line_reader_cap_and_eof_mid_buffer():
    """Complete lines buffered beyond the chunk cap come back as separate
    lines on later chunks, even when EOF (with a trailing unterminated line)
    arrives in between."""
    r, w = os.pipe()
    os.write(w, b"a\nb\nc\nd\ntail-no-newline")
    os.close(w)
    reader = _ServeLineReader(_PipeStream(r))
    assert [ln.strip() for ln in reader.next_chunk(2)[0]] == ["a", "b"]
    lines, eof = reader.next_chunk(2)
    assert [ln.strip() for ln in lines] == ["c", "d"] and not eof
    lines, eof = reader.next_chunk(2)
    assert lines == ["tail-no-newline"] and eof
    assert reader.next_chunk(2) == ([], True)
    os.close(r)


def test_line_reader_coalesces_available_lines():
    """Everything already on the fd lands in one chunk (up to the cap)."""
    r, w = os.pipe()
    os.write(w, b"1\n2\n3\n")
    reader = _ServeLineReader(_PipeStream(r))
    lines, eof = reader.next_chunk(10)
    assert [ln.strip() for ln in lines] == ["1", "2", "3"] and not eof
    os.write(w, b"4\n")
    os.close(w)
    lines, eof = reader.next_chunk(10)
    assert [ln.strip() for ln in lines] == ["4"] and eof
    os.close(r)


def test_line_reader_poll_and_unterminated_tail():
    """poll_chunk returns at once with nothing new, waits for new bytes up
    to its timeout, and gives an unterminated tail as a line at EOF."""
    r, w = os.pipe()
    reader = _ServeLineReader(_PipeStream(r))
    assert reader.poll_chunk(4, timeout=0.0) == ([], False)
    os.write(w, b"x\ny")
    lines, eof = reader.poll_chunk(4, timeout=0.5)
    assert lines == ["x\n"] and not eof
    os.close(w)
    lines, eof = reader.poll_chunk(4, timeout=0.5)
    assert lines == ["y"] and eof
    os.close(r)


def test_line_reader_reassembles_a_long_line():
    """A north-star-sized line (~110 KB) arrives over many reads and comes
    back whole."""
    s1, s2 = random_sequences(100_000, 10_000, seed=0)
    line = f"1 3 4 2 {s1} {s2} minimum\n".encode()
    r, w = os.pipe()

    def write():
        for i in range(0, len(line), 4096):
            os.write(w, line[i: i + 4096])
        os.write(w, b"1 3 4 2 ABCDE AB minimum\n")
        os.close(w)

    t = threading.Thread(target=write)
    t.start()
    reader = _ServeLineReader(_PipeStream(r))
    got = []
    eof = False
    while not eof:
        lines, eof = reader.next_chunk(8)
        got += lines
    t.join(timeout=30)
    assert not t.is_alive()
    assert got == [line.decode(), "1 3 4 2 ABCDE AB minimum\n"]
    os.close(r)


def test_closed_reply_pipe_exits_141(monkeypatch, capsys):
    """A BrokenPipeError on the reply stream ends the server with
    128+SIGPIPE, not a traceback (the JAX package's code).  capsys gives a
    stdout without an fd, so the exit leaves the test's own fds alone."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(qline(3) + "\n"))
    real_print = builtins.print

    def broken(*a, **k):
        if k.get("file") is None:
            raise BrokenPipeError()
        real_print(*a, **k)

    monkeypatch.setattr(builtins, "print", broken)
    assert cli.main(["--serve", "--quiet", "--device", "cpu"]) == 141
    monkeypatch.setattr(sys, "stdin", io.StringIO(qline(3) + "\n"))
    assert jax_cli.main(["--serve", "--quiet", "--backend", "numpy"]) == 141


@pytest.mark.parametrize("argv", [["--device-share", "50"], ["--backend", "hybrid"],
                                  ["--backend", "hybrid", "--listen", "0"]])
def test_serve_refuses_the_hybrid_split(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "stdin", io.StringIO(qline(3) + "\n"))
    assert cli.main(["--serve", "--quiet", "--device", "cpu", *argv]) == 2
    assert "single-query" in capsys.readouterr().err
    assert sys.stdin.tell() == 0
    assert jax_cli.main(["--serve", "--quiet", *argv]) == 2


@pytest.mark.parametrize("argv", [[], ["--backend", "auto"], ["--listen", "127.0.0.1:0"],
                                  ["--listen", "0", "--backend", "auto", "--json"]])
def test_serve_without_a_card_exits_2_at_start(monkeypatch, capsys, argv):
    """Without a card the device is resolved, and refused, before a line is
    read or the listening line is printed; the host backends still serve."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(qline(3) + "\n"))
    assert cli.main(["--serve", "--quiet", *argv]) == 2
    out, err = capsys.readouterr()
    assert out == "" and err.startswith("error:") and "listening" not in err
    assert sys.stdin.tell() == 0
    if "--listen" not in argv:
        assert cli.main(["--serve", "--quiet", "--backend", "native"]) == 0
        assert capsys.readouterr().out == jax_replies([qline(3)], False, False)[0] + "\n"


@pytest.mark.parametrize("stage", ["dispatch", "fetch"])
def test_device_failure_ends_the_loop(monkeypatch, capsys, stage):
    """A failure of the device path at dispatch or at fetch propagates: the
    loop exits 1 with an `error:` line, and no host engine answers."""
    def dispatch_fails(*a, **k):
        raise RuntimeError("sweep_batched launch failed (simulated)")

    def fetch_fails(*a, **k):
        def finish():
            raise RuntimeError("fetch failed (simulated)")
        return [], finish

    monkeypatch.setattr(batch, "batched_search_exact_async",
                        dispatch_fails if stage == "dispatch" else fetch_fails)
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "\n".join([qline(1), qline(2), "bad", qline(3)]) + "\n"))
    before = dict(native.calls)
    assert cli.main(["--serve", "--quiet", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "error: serving failed: RuntimeError" in err and "simulated" in err
    assert native.calls["search"] == before.get("search", 0)


def test_tcp_device_failure_raises_out_of_the_server(monkeypatch):
    """The TCP loop does not answer a failed chunk from another engine: the
    failure raises out of run() and the client sees its connection close
    without a reply."""
    def dispatch_fails(*a, **k):
        raise RuntimeError("simulated")

    monkeypatch.setattr(batch, "batched_search_exact_async", dispatch_fails)
    srv = server.TCPQueryServer("127.0.0.1", 0, backend="torch", lenient=False,
                                json_out=False, device="cpu", max_batch=8,
                                quiet=True)
    got = []

    def client():
        while srv.bound_addr is None:
            threading.Event().wait(0.01)
        with socket.create_connection(srv.bound_addr, timeout=30) as s:
            s.sendall((qline(1) + "\n").encode())
            s.shutdown(socket.SHUT_WR)
            try:
                got.append(s.recv(1 << 16))
            except ConnectionResetError:
                got.append(b"")

    t = threading.Thread(target=client)
    t.start()
    with pytest.raises(RuntimeError, match="simulated"):
        srv.run()
    t.join(timeout=30)
    assert not t.is_alive() and got == [b""]


def test_tcp_server_in_process_routes_replies():
    """The event loop on this (main) thread, four clients on threads, each
    with its own queries; stop on request once every client is answered."""
    srv = server.TCPQueryServer("127.0.0.1", 0, backend="torch", lenient=False,
                                json_out=False, device="cpu", max_batch=4,
                                quiet=True)
    sent = {c: [qline(70 + 5 * c + i, 300 + 50 * c, 30) for i in range(5)] + ["x y"]
            for c in range(4)}
    got = {}

    def client(c):
        while srv.bound_addr is None:
            threading.Event().wait(0.01)
        with socket.create_connection(srv.bound_addr, timeout=60) as s:
            s.sendall(("\n".join(sent[c]) + "\n").encode())
            s.shutdown(socket.SHUT_WR)
            buf = b""
            while True:
                d = s.recv(1 << 16)
                if not d:
                    break
                buf += d
        got[c] = buf.decode().splitlines()
        if len(got) == len(sent):
            srv.request_stop()

    threads = [threading.Thread(target=client, args=(c,)) for c in sent]
    for t in threads:
        t.start()
    assert srv.run() == 0
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for c, lines in sent.items():
        assert got[c] == jax_replies(lines, False, False)


@pytest.mark.parametrize("addr,want", [("8080", ("127.0.0.1", 8080)),
                                       ("0.0.0.0:0", ("0.0.0.0", 0)),
                                       (":77", ("127.0.0.1", 77)),
                                       ("::1:9", ("::1", 9))])
def test_parse_listen(addr, want):
    assert server.parse_listen(addr) == want


@pytest.mark.parametrize("addr", ["host:port", "x", "1:70000", ""])
def test_parse_listen_refuses(addr):
    with pytest.raises(ValueError):
        server.parse_listen(addr)


def test_json_reply_fields():
    """A --json reply holds the JAX package's fields; inf scores are the
    %g string."""
    lines = ["1 3 4 2 " + "?" * 20 + " !! maximum", qline(80)]
    got = server.process_query_lines(lines, backend="torch", lenient=True,
                                     json_out=True, device="cpu")[0]
    nomut, ok = (json.loads(r) for r in got)
    assert nomut == {"mutation_found": False, "offset": -1, "score": "-inf",
                     "mutant": "!!"}
    assert set(ok) == {"mutation_found", "offset", "char_offset", "substitute",
                       "score", "mutant"}


def test_finisher_reraises_and_keeps_fifo_order():
    fin = server.Finisher()

    class Pending:
        def __init__(self, v):
            self.v = v

        def finish(self):
            if self.v == "boom":
                raise ValueError("boom")
            return self.v

    for v in ("a", "boom", "c"):
        fin.submit(Pending(v), tag=v)
    assert fin.collect(timeout=10) == ("a", "a")
    with pytest.raises(ValueError, match="boom"):
        fin.collect(timeout=10)
    assert fin.collect(timeout=10) == ("c", "c")
    assert fin.inflight == 0 and fin.collect(timeout=0) is None
    fin.close()


def test_search_batch_async_equals_search_batch(monkeypatch):
    """finish() of the deferred call gives search_batch's results on mixed
    buckets (modes, weights, shapes, a shared Seq1, host and device
    buckets under `auto`)."""
    monkeypatch.setattr(batch.CONFIG, "auto_threshold", 40_000)
    ref = random_sequences(700, 1, seed=5)[0]
    qs = []
    for i, (n1, n2, w, is_max) in enumerate(
            [(300, 40, (1, 3, 4, 2), False), (300, 40, (2, 1, 1, 5), True),
             (900, 120, (1, 3, 4, 2), False), (1500, 77, (1, 3, 4, 2), False),
             (260, 30, (1, 3, 4, 2), False)]):
        a, b = random_sequences(n1, n2, seed=200 + i)
        qs.append(Query(np.array(w, float), a, b, is_max))
    for i in range(3):
        qs.append(Query(np.array([1.0, 3.0, 4.0, 2.0]), ref,
                        random_sequences(60, 50 + i, seed=300 + i)[1], True))
    for backend, device in [("torch", "cpu"), ("auto", "cpu"), ("native", None),
                            ("numpy", None)]:
        handles, finish = batch.search_batch_async(qs, backend=backend, device=device)
        if backend == "native" or backend == "numpy":
            assert handles == []
        else:
            assert handles
        assert finish() == batch.search_batch(qs, backend=backend, device=device)
