"""Closed-loop TCP clients of a serving entry: `clients` connections, each
sending one query line and reading its reply whole before it sends the
next, all released together.

A mix of this kind (traffic/<mix>.json) gives:
  seq1_len, seq2_len   every query's lengths (the same in every run)
  per_call             queries a request: 1 (one line, one reply)
  clients              concurrent connections
  pool                 distinct queries, each with its own Seq1, from the
                       seed; client c's k-th request is pool[(c + k) % pool]
  reply_timeout_s      a client's wait for one reply; past it the request
                       counts as failed and the client stops

The clients run in a process of their own (spawned in set-up, so they take
none of the server's interpreter), decode each reply there
(`psabench/replies.py`) and report each request as it returns: its pool
index, its send and its return on `time.perf_counter` (the system-wide
monotonic clock on Linux, so the two processes' times compare) and the
decoded answer.  The server runs on this process's main thread for the
window (the entry's `serve`); a thread here takes the reports, calls
`before` once a returned request, and once every client has stopped, stops
the server as an operator does, with SIGTERM to its process.

A traced run's profiler is started and stopped on that thread, so its trace
holds the card's work from every thread and, of the host, only the
harness's `request` marks: one from each return to the next while the
profiler runs.  A request is profiled when it returns while the profiler
runs.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Connection
from pathlib import Path

from psabench.traffic.closed_loop import Request

HOST = "127.0.0.1"
CONNECT_S = 60.0        # a client's wait for the server to listen
READ_BYTES = 1 << 20


def check_mix(mix: dict) -> None:
    n1, n2 = int(mix["seq1_len"]), int(mix["seq2_len"])
    if (not 0 < n2 <= n1 or int(mix["per_call"]) != 1
            or int(mix["pool"]) < 1 or int(mix["clients"]) < 1
            or float(mix["reply_timeout_s"]) <= 0):
        raise ValueError(f"bad tcp_clients mix {mix}")


def make_pool(mix: dict, seed: int) -> list:
    """The run's distinct queries: `pool` lists of one (seq1, seq2)."""
    from psabench import generator

    check_mix(mix)
    return generator.make_calls(seed, int(mix["pool"]), 1,
                                int(mix["seq1_len"]), int(mix["seq2_len"]))


def pairs_per_call(mix: dict) -> int:
    from psabench import roofline

    return roofline.pairs(int(mix["seq1_len"]), int(mix["seq2_len"]))


def free_port() -> int:
    with socket.create_server((HOST, 0)) as s:
        return s.getsockname()[1]


def warm(entry, prepared: list, mix: dict) -> None:
    """The set-up: the entry's own (the server's device, finisher and
    warm-up, from the pool's lines), and the clients' process, started and
    ready to connect."""
    port = free_port()
    entry.setup(prepared, port)
    entry.clients = Clients(prepared, port, mix)


class Clients:
    """The clients' process (a fresh interpreter that imports this module
    alone) and the connection to it, a socket pair."""

    def __init__(self, lines: list, port: int, mix: dict):
        mine, theirs = socket.socketpair()
        code = ("import sys; from psabench.traffic import tcp_clients; "
                "tcp_clients.child(int(sys.argv[1]))")
        with mine, theirs:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", code, str(theirs.fileno())],
                cwd=Path(__file__).resolve().parents[2],
                pass_fds=(theirs.fileno(),))
            self.conn = Connection(os.dup(mine.fileno()))
        self.conn.send((lines, port, int(mix["clients"]),
                        float(mix["reply_timeout_s"])))
        if self.conn.recv() != "ready":
            raise RuntimeError("the clients' process did not start")

    def close(self) -> None:
        self.conn.close()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)


def drive(entry, prepared: list, seconds: float, before=None,
          request_scope=None) -> list:
    """Release the clients for a window of `seconds` (each sends no request
    after it) and serve them on this thread until they have all stopped.
    Returns every Request in the order of their returns."""
    clients = entry.clients
    out: list = []
    served = threading.Event()
    failure: list = []
    # while the server is not in place, a SIGTERM does nothing: the server
    # saves this handler and puts it back when it stops
    term = signal.signal(signal.SIGTERM, _ignore)
    if before is not None:
        _set_up_profiler()
    taker = threading.Thread(
        target=_take, name="psabench-tcp-taker", daemon=True,
        args=(clients, out, served, failure, before, request_scope))
    rc = 1
    try:
        taker.start()
        clients.conn.send(("go", seconds))
        rc = entry.serve()
    finally:
        if rc:
            clients.proc.kill()     # no server: end the reports the taker reads
        served.set()
        taker.join()
        clients.close()
        signal.signal(signal.SIGTERM, term)
    if rc:
        raise RuntimeError(f"the server exited {rc}")
    if failure:
        raise failure[0]
    out.sort(key=lambda r: r.t1)
    return out


def _ignore(*_a) -> None:
    pass


def _set_up_profiler() -> None:
    """Start and stop an empty profile on this, the main, thread before the
    window.  The profiler's library sets itself up on the first start, and
    only on the thread that registered it at import; first started on the
    reports' thread it says "External init callback must run in same thread
    as registerClient" and may record none of the card's work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    prof.stop()


def _take(clients, out: list, served, failure: list, before, request_scope):
    """The reports' thread: a Request a report, `before` after each, the
    profile's `request` marks, then the server's stop."""
    try:
        _reports(clients, out, before, request_scope)
    except BaseException as e:  # noqa: BLE001 - re-raised by drive
        failure.append(e)
    # SIGTERM once the server's own handler is in place; not at all if it
    # has returned
    while not served.is_set():
        if signal.getsignal(signal.SIGTERM) is not _ignore:
            os.kill(os.getpid(), signal.SIGTERM)
            return
        time.sleep(0.01)


def _reports(clients, out: list, before, request_scope) -> None:
    start = None
    on: list = []           # [start, end) of each stretch the profile ran
    mark = None             # the open `request` mark while it runs
    try:
        while True:
            try:
                msg = clients.conn.recv()
            except EOFError:
                break
            if msg[0] == "start":
                start = msg[1]
                continue
            if msg[0] == "done":
                break
            _, call, t0, t1, answer, error = msg
            out.append(Request(call, t0, t1,
                               None if error else [answer], error))
            if before is None:
                continue
            if mark is not None:
                mark.__exit__(None, None, None)
                mark = None
            now = time.perf_counter()
            profiled = bool(before(now - start))
            if profiled and not (on and on[-1][1] is None):
                on.append([now, None])
            elif not profiled and on and on[-1][1] is None:
                on[-1][1] = now
            if profiled and request_scope is not None:
                mark = request_scope()
                mark.__enter__()
    finally:
        if mark is not None:
            mark.__exit__(None, None, None)
        if before is not None:
            before(None)
            if on and on[-1][1] is None:
                on[-1][1] = time.perf_counter()
    for r in out:
        r.profiled = any(a <= r.t1 < b for a, b in on)


# --- the clients' process ---------------------------------------------------


def child(fd: int) -> None:
    """The clients' process: its orders come on the connection at `fd`."""
    conn = Connection(fd)
    try:
        _clients_main(conn, *conn.recv())
    except EOFError:
        pass
    finally:
        conn.close()


def _clients_main(conn, lines: list, port: int, n: int,
                  timeout_s: float) -> None:
    """Wait for ("go", seconds); then `n` clients connect, start together
    and send until `seconds` have passed since the start; report each
    request, then ("done",)."""
    from psabench import replies

    payload = [ln.encode("ascii") for ln in lines]
    seq2s = [ln.split(" ")[5] for ln in lines]
    lock = threading.Lock()

    def report(msg) -> None:
        with lock:
            conn.send(msg)

    conn.send("ready")
    seconds = conn.recv()[1]
    clock: dict = {}

    def released():
        clock["start"] = time.perf_counter()
        report(("start", clock["start"]))

    gate = threading.Barrier(n, action=released)

    def client(c: int) -> None:
        sock = _connect(port)
        try:
            gate.wait(timeout=CONNECT_S)
        except threading.BrokenBarrierError:
            pass
        k = 0
        try:
            while time.perf_counter() - clock.get("start", 0.0) < seconds:
                i = (c + k) % len(lines)
                k += 1
                t0 = time.perf_counter()
                if sock is None:
                    reply, error = "", "no connection to the server"
                else:
                    reply, error = _ask(sock, payload[i], t0 + timeout_s)
                t1 = time.perf_counter()
                try:
                    answer = (None if error
                              else replies.decode(reply, seq2s[i]))
                except Exception as e:  # noqa: BLE001 - a failed request
                    answer, error = None, f"{type(e).__name__}: {e}"
                report(("request", i, t0, t1, answer, error))
                if error:
                    return      # the stream's order is lost: this client stops
        finally:
            if sock is not None:
                sock.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report(("done",))


def _connect(port: int):
    """A connection to the server, retried while it is not yet listening;
    None when it never listens."""
    deadline = time.perf_counter() + CONNECT_S
    while True:
        try:
            return socket.create_connection((HOST, port), timeout=CONNECT_S)
        except OSError:
            if time.perf_counter() >= deadline:
                return None
            time.sleep(0.01)


def _ask(sock, line: bytes, deadline: float) -> tuple:
    """Send one line and read its reply whole -> (reply, error); the error
    is "" for a reply, else why none came by `deadline`."""
    buf = bytearray()
    try:
        sock.settimeout(max(deadline - time.perf_counter(), 1e-3))
        sock.sendall(line)
        while True:
            sock.settimeout(max(deadline - time.perf_counter(), 1e-3))
            data = sock.recv(READ_BYTES)
            if not data:
                return "", "the server closed the connection"
            seen = len(buf)
            buf += data
            if buf.find(b"\n", seen) >= 0:
                break
    except TimeoutError:
        return "", "no reply within the timeout"
    except OSError as e:
        return "", f"{type(e).__name__}: {e}"
    nl = buf.find(b"\n")
    if nl != len(buf) - 1:
        return "", "more than one reply to one line"
    return buf[:nl].decode("ascii", "replace"), ""
