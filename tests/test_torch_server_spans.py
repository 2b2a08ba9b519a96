"""The serve loops' spans (`psa_torch.utils.server`) on the CPU: a TCP server
in this process with three concurrent clients records `serve_read`,
`serve_chunk`, `parse`, `reply` and `route`, joined into one request a
chunk across the loop's and the finishing thread; the stdin loop records
`serve_chunk`, `parse` and `reply`; and the replies are the same bytes with
the recorder off."""

import io
import socket
import threading

import pytest

from psa_torch.utils import cli, server, spans
from psa_torch.utils.generator import random_sequences

NCLIENTS = 3
PER_CLIENT = 2


@pytest.fixture(autouse=True)
def fresh_ring():
    was = spans.enable(True)
    spans.clear()
    yield
    spans.enable(was)
    spans.clear()


def qline(seed: int) -> str:
    s1, s2 = random_sequences(900, 120, seed=seed)
    return f"1 3 4 2 {s1} {s2} minimum\n"


LINES = {c: [qline(10 * c + k) for k in range(PER_CLIENT)]
         for c in range(NCLIENTS)}


def client(port: int, lines: list, out: dict, c: int) -> None:
    """A closed loop: each line sent once the last reply was read whole."""
    got = []
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        buf = b""
        for ln in lines:
            s.sendall(ln.encode())
            while b"\n" not in buf:
                data = s.recv(1 << 16)
                assert data, "the server closed the connection"
                buf += data
            reply, buf = buf.split(b"\n", 1)
            got.append(reply)
    out[c] = got


def serve_tcp_once() -> dict:
    """The TCP server on this (the main) thread, three client threads; the
    server stops once they are done.  -> {client: [reply bytes]}"""
    srv = server.TCPQueryServer("127.0.0.1", 0, backend="torch",
                                lenient=False, json_out=False, device="cpu",
                                max_batch=256, quiet=True)
    out: dict = {}

    def clients():
        while srv.bound_addr is None:
            threading.Event().wait(0.01)
        ts = [threading.Thread(target=client,
                               args=(srv.bound_addr[1], LINES[c], out, c))
              for c in range(NCLIENTS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        srv.request_stop()

    starter = threading.Thread(target=clients)
    starter.start()
    assert srv.run() == 0
    starter.join()
    assert sorted(out) == list(range(NCLIENTS))
    return out


def by_name(recs) -> dict:
    out: dict = {}
    for s in recs:
        out.setdefault(s.name, []).append(s)
    return out


def test_the_tcp_server_records_its_spans():
    serve_tcp_once()
    recs = spans.records()
    named = by_name(recs)
    ids = {s.id: s for s in recs}
    assert {"serve_read", "serve_chunk", "parse", "reply",
            "route"} <= set(named)
    sent = NCLIENTS * PER_CLIENT
    chunks = named["serve_chunk"]
    assert sum(s.attrs["queries"] for s in chunks) == sent
    assert sum(s.attrs["lines"] for s in chunks) == sent
    assert all(s.parent is None and s.attrs["queue_us"] >= 0 for s in chunks)
    # every read is a root of its own; together they read every line
    reads = named["serve_read"]
    assert all(s.parent is None for s in reads)
    assert sum(s.attrs["lines"] for s in reads) == sent
    assert sum(s.attrs["bytes"] for s in reads) == sum(
        len(ln) for c in LINES.values() for ln in c)
    chunk_ids = {s.id for s in chunks}
    for name in ("parse", "search_batch", "reply", "route"):
        assert named[name], name
        for s in named[name]:
            up = ids[s.parent]
            assert s.parent in chunk_ids and s.request == up.request, name
    # the reply is formatted on the finishing thread, after the dispatch
    for s in named["reply"]:
        assert s.start_ns >= ids[s.parent].end_ns
        assert s.attrs["bytes"] > 0
    assert sum(s.attrs["bytes"] for s in named["route"]) == sum(
        s.attrs["bytes"] for s in named["reply"]) + sent   # a newline a reply
    # the batch path's own spans join the chunk's request
    reqs = {s.request for s in chunks}
    assert {s.request for s in named["fetch_wait"]} <= reqs


def test_the_replies_are_the_same_with_the_recorder_off():
    on = serve_tcp_once()
    spans.enable(False)
    spans.clear()
    off = serve_tcp_once()
    assert spans.records() == []
    assert on == off
    want = server.process_query_lines(
        [ln for c in range(NCLIENTS) for ln in LINES[c]], backend="torch",
        lenient=False, json_out=False, device="cpu")[0]
    assert [r.decode() for c in range(NCLIENTS) for r in on[c]] == want


def test_the_stdin_loop_records_its_spans(capsys):
    args = cli.build_parser().parse_args(["--serve", "--device", "cpu",
                                          "--quiet"])
    assert cli._fold_device_share(args) is None
    text = "".join(LINES[0]) + "not a query\n"
    rc = cli._serve_loop(args, cli._ServeLineReader(io.StringIO(text)),
                         "cpu")
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == PER_CLIENT + 1 and out[-1].startswith("error ")
    recs = spans.records()
    named = by_name(recs)
    ids = {s.id: s for s in recs}
    assert {"serve_chunk", "parse", "reply"} <= set(named)
    chunks = named["serve_chunk"]
    assert sum(s.attrs["lines"] for s in chunks) == PER_CLIENT + 1
    assert sum(s.attrs["queries"] for s in chunks) == PER_CLIENT
    assert all(s.attrs["queue_us"] >= 0 for s in chunks)
    for s in named["reply"] + named["parse"]:
        assert ids[s.parent].name == "serve_chunk"
