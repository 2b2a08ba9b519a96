"""The port's TCP serving front-end (`psa-torch --serve --listen`) as a real
subprocess, raw sockets as clients: routing and order across concurrent
clients, the unterminated tail, a vanishing client, adversarial lines, JSON
replies, a bad address and a port in use.  The server runs once on the
plain versions of the kernels (`--device cpu`) and once on the native host
engine; expected replies come from the JAX package's numpy engine."""

import json
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from psa_tpu.models.search import AlignmentSearchEngine
from psa_tpu.utils.generator import random_sequences

ROOT = Path(__file__).resolve().parent.parent
SERVE = [sys.executable, "-m", "psa_torch.utils.cli", "--serve"]


class _Server:
    def __init__(self, *extra_args):
        self.proc = subprocess.Popen([*SERVE, "--listen", "127.0.0.1:0", *extra_args],
                                     cwd=ROOT, stderr=subprocess.PIPE, text=True)
        line = self.proc.stderr.readline()
        assert "listening on" in line, line
        self.port = int(line.rsplit(":", 1)[1])

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=30)
        self.proc.stderr.close()
        return rc

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.stop()
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


@pytest.fixture(scope="module", params=[["--device", "cpu"], ["--backend", "native"]],
                ids=["cpu", "native"])
def srv(request):
    s = _Server("--quiet", *request.param)
    yield s
    s.close()


def _recv_all(s) -> str:
    buf = b""
    while True:
        d = s.recv(1 << 16)
        if not d:
            break
        buf += d
    return buf.decode()


def _roundtrip(port: int, lines, terminate: bool = True):
    """Send lines, read every reply line until the server closes."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        payload = "\n".join(lines) + ("\n" if terminate else "")
        s.sendall(payload.encode())
        s.shutdown(socket.SHUT_WR)
        return _recv_all(s).splitlines()


def _expected_line(wline: str) -> str:
    toks = wline.split()
    eng = AlignmentSearchEngine(np.array([float(t) for t in toks[:4]]),
                                toks[6] == "maximum", backend="numpy")
    res = eng.search(toks[4], toks[5])
    return "%d %g %s" % (res.offset, res.score, res.mutant(toks[5]))


def _qline(seed, n1=300, n2=40, weights="1 3 4 2", mode="minimum"):
    s1, s2 = random_sequences(n1, n2, seed=seed)
    return f"{weights} {s1} {s2} {mode}"


def test_tcp_error_and_order(srv):
    q = _qline(1)
    replies = _roundtrip(srv.port, [q, "not a query", "", q])
    assert len(replies) == 3
    assert replies[0] == replies[2] == _expected_line(q)
    assert replies[1].startswith("error ")


def test_tcp_concurrent_clients_routing_and_order(srv):
    """Interleaved clients: every reply lands on its own connection in that
    connection's send order (distinct queries per client)."""
    queries = {c: [_qline(100 + 7 * c + i, 120 + 13 * c, 17 + c,
                          mode="maximum" if i % 2 else "minimum") for i in range(3 + c)]
               for c in range(4)}
    results = {}

    def run(c):
        results[c] = _roundtrip(srv.port, queries[c])

    threads = [threading.Thread(target=run, args=(c,)) for c in queries]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for c, qs in queries.items():
        assert results[c] == [_expected_line(q) for q in qs], c


def test_tcp_unterminated_tail_is_answered(srv):
    """No trailing newline: the client's FIN flushes the tail as a query."""
    q = _qline(5)
    assert _roundtrip(srv.port, [q], terminate=False) == [_expected_line(q)]


def test_tcp_client_vanishing_does_not_kill_server(srv):
    q = _qline(6)
    a = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
    a.sendall((q + "\n").encode())
    a.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                 b"\x01\x00\x00\x00\x00\x00\x00\x00")  # RST on close
    a.close()
    assert _roundtrip(srv.port, [q]) == [_expected_line(q)]
    assert srv.proc.poll() is None


def test_tcp_adversarial_inputs_do_not_kill_server(srv):
    """Binary garbage, NUL bytes, a 2 MB line and invalid UTF-8 each get a
    reply on their own connection while the server keeps serving correct
    answers to everyone else."""
    garbage = [
        b"\x00\x01\x02\xff\xfe binary\n",
        b"1 3 4 2 " + b"A" * (2 << 20) + b" ABC minimum\n",  # 2 MB line
        "1 3 4 2 SéQ ABC minimum\n".encode(),           # non-ASCII
        b"\n\n\n",                                           # blanks
    ]
    with socket.create_connection(("127.0.0.1", srv.port), timeout=120) as s:
        for g in garbage:
            s.sendall(g)
        s.shutdown(socket.SHUT_WR)
        replies = _recv_all(s).splitlines()
    # 3 non-blank lines -> 3 replies; the 2 MB one is a well-formed query
    # over one letter, answered like any other
    assert len(replies) == 3
    assert replies[0].startswith("error") and replies[2].startswith("error")
    assert replies[1] == _expected_line("1 3 4 2 " + "A" * (2 << 20) + " ABC minimum")
    q = "1 3 4 2 ABCDEFGHIJ ABC minimum"
    assert _roundtrip(srv.port, [q]) == [_expected_line(q)]


def test_tcp_json_replies_and_clean_stop():
    srv = _Server("--quiet", "--json", "--backend", "native")
    try:
        q = _qline(7, mode="maximum")
        replies = _roundtrip(srv.port, [q, "bad", "1 3 4 2 ???? !! minimum"])
        assert len(replies) == 3
        obj = json.loads(replies[0])
        want = _expected_line(q).split()
        assert obj["mutation_found"] and obj["offset"] == int(want[0])
        assert obj["mutant"] == want[2]
        assert json.loads(replies[1]).keys() == {"error"}
        assert json.loads(replies[2]).keys() == {"error"}   # strict alphabet
        assert srv.stop() == 0
    finally:
        srv.close()


@pytest.mark.parametrize("addr", ["not-a-port", "host:port"])
def test_tcp_bad_listen_address(addr):
    proc = subprocess.run([*SERVE, "--listen", addr, "--backend", "native"],
                          cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "bad --listen" in proc.stderr and "listening" not in proc.stderr


def test_tcp_port_in_use():
    blocker = socket.create_server(("127.0.0.1", 0))
    port = blocker.getsockname()[1]
    try:
        proc = subprocess.run([*SERVE, "--listen", f"127.0.0.1:{port}",
                               "--backend", "native"],
                              cwd=ROOT, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 2
        assert "cannot listen" in proc.stderr
    finally:
        blocker.close()
