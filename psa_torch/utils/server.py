"""Network serving front-end: a TCP query server that batches across
clients, and the chunk functions it shares with the stdin serve loop
(utils/cli._serve_loop).

The reference is a one-shot batch program (main.c:13-56); its serving
analog is a long-lived process that fills device batches from many
concurrent clients:

- one single-threaded `selectors` event loop owns every connection (the
  device dispatch is serial per card, so client threads would only add
  locking);
- each readable socket drains into a per-connection buffer; complete lines
  join one FIFO across ALL connections, so concurrent low-rate clients
  coalesce into full device batches (continuous batching);
- replies are routed back per connection in that connection's send order
  (the FIFO keeps arrival order and search_batch returns in input order,
  so no sequence numbers are needed);
- a malformed line yields an `error ...` reply on its own connection and
  the server keeps going; a vanished client is dropped without disturbing
  the batch (its replies are discarded at routing time).

Protocol per line: the 7 input-file tokens (4 weights, Seq1, Seq2, mode),
reply `<offset> <score%g> <mutant>` / `-1 <inf|-inf> <seq2>` / `error <msg>`,
the same as the pipe server's, so anything speaking the stdin protocol can
speak TCP by pointing at host:port.

Device buckets run on `device` (models/batch.search_batch_async), or
shard their queries over `mesh` when one is given (`--serve --sharded`).  A
failure there raises out of the loop: no host engine answers in the
device's place.
"""

from __future__ import annotations

import json
import queue
import selectors
import signal
import socket
import sys
import threading
import time
import types
from collections import deque


class PendingReplies:
    """One in-flight serve chunk: parse errors already resolved, device
    buckets dispatched (uploads, kernels and fetches enqueued), replies
    completed by `finish()`, which the serve loops run on the Finisher
    thread so client I/O keeps draining while the fetch waits."""

    __slots__ = ("_outputs", "_queries", "_slots", "_handles", "_finish",
                 "_t0", "_json")

    def __init__(self, outputs, queries, slots, handles, finish_fn,
                 t0: float, json_out: bool):
        self._outputs = outputs
        self._queries = queries
        self._slots = slots
        # the in-flight fetches: they hold the pinned buffers the queued
        # copies write, so they live until finish() has returned
        self._handles = handles
        self._finish = finish_fn
        self._t0 = t0
        self._json = json_out

    def finish(self):
        """Complete the chunk -> (outputs, n_queries, seconds); blocks until
        the device results land, then formats the replies in input order."""
        results = self._finish()
        dt = time.perf_counter() - self._t0
        for j, q, res in zip(self._slots, self._queries, results):
            if self._json:
                from psa_torch.utils.cli import _result_json

                self._outputs[j] = _result_json(q, res)
            elif res is None:
                bad = float("-inf") if q.is_max else float("inf")
                self._outputs[j] = "-1 %g %s" % (bad, q.seq2)
            else:
                self._outputs[j] = "%d %g %s" % (res.offset, res.score,
                                                 res.mutant(q.seq2))
        self._handles = ()
        return self._outputs, len(self._queries), dt


def dispatch_query_lines(lines, *, backend: str, lenient: bool,
                         json_out: bool, device=None,
                         mesh=None) -> PendingReplies:
    """Front half of one serve chunk: parse and validate every line,
    dispatch the device buckets (models/batch.search_batch_async) on
    `device` (None = the card), or sharded over `mesh` when one is given
    (`psa-torch --serve --sharded`), and return a PendingReplies whose finish()
    gives the aligned reply lines.  `outputs[j]` is the reply to `lines[j]`
    (None for a blank line, which gets no reply)."""
    from psa_torch.models.batch import search_batch_async
    from psa_torch.utils.io import parse_query_lines

    # parse and validate the whole chunk in one pass (the native C scanner
    # when the library is available, Python otherwise; the same entries)
    outputs: list = [None] * len(lines)
    queries, slots = [], []
    for j, ent in enumerate(parse_query_lines(lines,
                                              check_alphabet=not lenient)):
        if ent is None:
            continue
        if isinstance(ent, str):
            outputs[j] = _error_json(ent) if json_out else f"error {ent}"
        else:
            queries.append(ent)
            slots.append(j)
    t0 = time.perf_counter()
    if queries:
        handles, finish_fn = search_batch_async(
            queries, backend=backend, strict_alphabet=False, device=device,
            mesh=mesh)
    else:
        handles, finish_fn = [], (lambda: [])
    return PendingReplies(outputs, queries, slots, handles, finish_fn, t0,
                          json_out)


def process_query_lines(lines, *, backend: str, lenient: bool,
                        json_out: bool, device=None, mesh=None):
    """One synchronous serve chunk: query lines -> aligned reply lines.

    Returns (outputs, n_queries, seconds).  The stdin serve loop and the
    TCP server speak the same protocol through this one implementation
    (dispatch_query_lines + finish)."""
    return dispatch_query_lines(lines, backend=backend, lenient=lenient,
                                json_out=json_out, device=device,
                                mesh=mesh).finish()


def _error_json(msg: str) -> str:
    return json.dumps({"error": msg})


class Finisher:
    """One background thread completing PendingReplies in dispatch order.

    `finish()` blocks on the fetch's CUDA event, whose synchronize releases
    the GIL, so running it off the loop lets the serve loops parse, encode
    and dispatch the NEXT chunk while the oldest one's results travel and
    are selected.  Results come back strictly FIFO (one worker), so reply
    order is unchanged.  An exception from finish() re-raises on the
    collecting thread.  Device work enqueued from this thread (the near > k
    re-sweep of host selection) goes to the same default stream as the
    loop's dispatches."""

    def __init__(self):
        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._n = 0              # submitted, not yet collected
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="psa-finisher")
        self._t.start()

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                return
            tag, pending = item
            try:
                self._out.put(("ok", tag, pending.finish()))
            except BaseException as e:  # noqa: BLE001 - re-raised by collect
                self._out.put(("err", tag, e))

    def submit(self, pending, tag=None) -> None:
        self._n += 1
        self._in.put((tag, pending))

    def call(self, fn):
        """Run fn() on the finisher thread and return its result (its
        exception re-raises here), with nothing else in flight: the serve
        warmup finishes its chunks this way, so the thread that finishes
        the clients' chunks has run one before them."""
        self.submit(types.SimpleNamespace(finish=fn))
        return self.collect(timeout=None)[1]

    @property
    def inflight(self) -> int:
        return self._n

    def collect(self, timeout: float | None):
        """(tag, (outputs, nq, dt)) of the oldest chunk; None if nothing
        completes within `timeout` (0 = non-blocking, None = wait)."""
        try:
            kind, tag, payload = self._out.get(
                block=timeout != 0, timeout=timeout or None)
        except queue.Empty:
            return None
        self._n -= 1
        if kind == "err":
            raise payload
        return tag, payload

    def close(self, wait: bool = True) -> None:
        """Stop the worker once the queued chunks drain.  wait=False
        abandons in-flight work instead (the broken-pipe exit: nobody reads
        the replies, and a slow fetch must not stall the exit; the daemon
        thread dies with the process)."""
        self._in.put(None)
        if wait:
            self._t.join(timeout=10)


class _Conn:
    """Per-connection state: input line buffer, reply outbox, lifecycle."""

    __slots__ = ("sock", "inbuf", "outbuf", "read_eof", "npending",
                 "interest")

    def __init__(self, sock):
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.read_eof = False       # client finished sending (FIN)
        self.npending = 0           # its lines still waiting in the FIFO
        self.interest = 0           # current selector event mask

    def take_lines(self, out: deque) -> None:
        """Move complete lines from inbuf into the shared FIFO; a line that
        spans several recv calls waits in inbuf until its newline."""
        while True:
            nl = self.inbuf.find(b"\n")
            if nl < 0:
                break
            out.append((self, self.inbuf[: nl + 1].decode("utf-8", "replace")))
            self.npending += 1
            del self.inbuf[: nl + 1]

    def flush_tail(self, out: deque) -> None:
        """On EOF, a final unterminated line is still a query (the pipe
        server honours it too: _ServeLineReader's tail rule)."""
        if self.inbuf:
            out.append((self, self.inbuf.decode("utf-8", "replace")))
            self.npending += 1
            self.inbuf.clear()

    def done(self) -> bool:
        return self.read_eof and not self.outbuf and self.npending == 0


class TCPQueryServer:
    """Single-threaded batching TCP server over `dispatch_query_lines`.

    `port=0` binds an ephemeral port; the bound address is announced on
    stderr as `[serve] listening on HOST:PORT` (machine-parseable: tests
    and launchers read it).  SIGINT/SIGTERM, or `request_stop()`, ask for a
    clean stop: the loop finishes the in-flight chunks, flushes the
    outboxes and returns 0.  `run()` installs the signal handlers, so it
    runs on the process's main thread.
    """

    # selector timeout while idle: bounds the reaction to a signal (PEP 475
    # retries select after the handler runs, so a plain blocking select
    # would absorb the wakeup)
    _IDLE_TICK = 0.25
    # selector timeout while a chunk is in flight: the loop keeps draining
    # sockets and polls the finisher thread between selects, so this bounds
    # added reply latency, not throughput
    _POLL_TICK = 0.002

    def __init__(self, host: str, port: int, *, backend: str, lenient: bool,
                 json_out: bool, device, max_batch: int, quiet: bool,
                 mesh=None, finisher: Finisher | None = None):
        from psa_torch.config import CONFIG

        self._addr = (host, port)
        self._backend = backend
        self._lenient = lenient
        self._json = json_out
        self._device = device
        self._mesh = mesh
        self._max_batch = max(1, max_batch)
        # dispatched-but-uncollected chunks: the finisher thread waits on
        # the oldest fetch while this loop drains, parses and dispatches the
        # next (PSA_SERVE_INFLIGHT)
        self._max_inflight = max(1, CONFIG.serve_inflight)
        self._quiet = quiet
        self._stop = False
        self._served = 0
        self._fin: Finisher | None = None   # set for run()'s lifetime
        # a finisher made (and warmed) before the server; run() closes it
        self._given_fin = finisher
        self.bound_addr: tuple | None = None

    def request_stop(self, *_a) -> None:
        self._stop = True

    def _log(self, msg: str) -> None:
        if not self._quiet:
            print(msg, file=sys.stderr, flush=True)

    def run(self) -> int:
        sel = selectors.DefaultSelector()
        try:
            lsock = socket.create_server(self._addr, backlog=64)
        except OSError as e:
            print(f"error: cannot listen on "
                  f"{self._addr[0]}:{self._addr[1]}: {e}", file=sys.stderr)
            if self._given_fin is not None:
                self._given_fin.close()
            return 2
        lsock.setblocking(False)
        self.bound_addr = lsock.getsockname()[:2]
        # always announced, even under --quiet: launchers and tests parse
        # this line to learn the ephemeral port (the one piece of stderr
        # output that is protocol, not progress)
        print(f"[serve] listening on "
              f"{self.bound_addr[0]}:{self.bound_addr[1]}",
              file=sys.stderr, flush=True)
        sel.register(lsock, selectors.EVENT_READ, None)

        old_int = signal.signal(signal.SIGINT, self.request_stop)
        old_term = signal.signal(signal.SIGTERM, self.request_stop)
        fifo: deque = deque()       # (conn, line) across every connection
        self._fin = fin = self._given_fin or Finisher()
        abandon = True
        try:
            while not self._stop:
                # zero timeout ONLY when a dispatch can happen this pass; a
                # full pipeline waits on the poll tick instead: a
                # zero-timeout spin would hold the GIL against the finisher
                n0 = len(fifo)
                can_dispatch = fin.inflight < self._max_inflight
                if fifo and can_dispatch:
                    timeout = 0
                elif fifo or fin.inflight:
                    timeout = self._POLL_TICK
                else:
                    timeout = self._IDLE_TICK
                events = sel.select(timeout)
                for key, mask in events:
                    if key.data is None:
                        self._accept(sel, lsock)
                    else:
                        self._handle(sel, key.data, mask, fifo)
                # route every chunk the finisher thread completed (it waits
                # on the oldest fetch in the background while this loop
                # keeps draining and dispatching)
                while True:
                    got = fin.collect(timeout=0)
                    if got is None:
                        break
                    self._route(sel, fifo, got[0], got[1])
                # dispatch only a FULL batch, or a partial one once input is
                # quiescent (no new line arrived this pass): one recv per
                # connection per pass would otherwise give small odd-sized
                # dispatches, each paying a device round trip
                if (fifo and fin.inflight < self._max_inflight
                        and (len(fifo) >= self._max_batch
                             or len(fifo) == n0)):
                    self._dispatch(sel, fifo)
            # clean stop: finish in-flight chunks, drop unprocessed lines,
            # flush what was answered
            while fin.inflight:
                got = fin.collect(timeout=None)
                self._route(sel, fifo, got[0], got[1])
            self._drain_outboxes(sel)
            abandon = False
        finally:
            # after a failure nobody waits for the chunks still in flight
            fin.close(wait=not abandon)
            self._fin = None
            signal.signal(signal.SIGINT, old_int)
            signal.signal(signal.SIGTERM, old_term)
            for key in list(sel.get_map().values()):
                try:
                    key.fileobj.close()
                except OSError:
                    pass
            sel.close()
        self._log(f"[serve] stopped ({self._served} queries served)")
        return 0

    def _accept(self, sel, lsock) -> None:
        try:
            sock, _ = lsock.accept()
        except OSError:
            return
        sock.setblocking(False)
        conn = _Conn(sock)
        conn.interest = selectors.EVENT_READ
        sel.register(sock, conn.interest, conn)

    def _sync_interest(self, sel, conn: _Conn, fifo: deque) -> None:
        """Keep the selector registration equal to what the connection can
        progress on: READ until the client's FIN (an EOF socket is readable
        forever; READ interest would spin the loop and defeat the
        quiescence test), WRITE only while replies are queued.  A conn with
        neither (EOF, replies still being computed) parks unregistered
        until _route gives it output."""
        if conn.sock.fileno() < 0:
            return
        want = 0
        if not conn.read_eof:
            want |= selectors.EVENT_READ
        if conn.outbuf:
            want |= selectors.EVENT_WRITE
        if want == conn.interest:
            return
        if not want:
            sel.unregister(conn.sock)
        elif not conn.interest:
            sel.register(conn.sock, want, conn)
        else:
            sel.modify(conn.sock, want, conn)
        conn.interest = want

    def _handle(self, sel, conn: _Conn, mask: int, fifo: deque) -> None:
        if mask & selectors.EVENT_READ and not conn.read_eof:
            # drain the socket until it would block, or until this
            # connection alone could fill the dispatch pipeline plus the
            # next batch (per-client backpressure: the rest stays in the
            # kernel's buffer until its lines are routed)
            while conn.npending < self._max_batch * (self._max_inflight + 1):
                try:
                    data = conn.sock.recv(1 << 16)
                except BlockingIOError:
                    break
                except OSError:
                    self._close(sel, conn, fifo)
                    return
                if data:
                    conn.inbuf += data
                    conn.take_lines(fifo)
                else:
                    conn.read_eof = True
                    conn.flush_tail(fifo)
                    if conn.done():
                        self._close(sel, conn, fifo)
                        return
                    break
        if mask & selectors.EVENT_WRITE:
            self._write(sel, conn, fifo)
            return                  # _write already synced interest/closed
        self._sync_interest(sel, conn, fifo)

    def _write(self, sel, conn: _Conn, fifo: deque) -> None:
        if conn.outbuf:
            try:
                n = conn.sock.send(conn.outbuf)
                del conn.outbuf[:n]
            except BlockingIOError:
                return
            except OSError:
                self._close(sel, conn, fifo)
                return
        if not conn.outbuf and conn.done():
            self._close(sel, conn, fifo)
        else:
            self._sync_interest(sel, conn, fifo)

    def _close(self, sel, conn: _Conn, fifo: deque) -> None:
        if conn.interest:
            try:
                sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.interest = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.read_eof = True
        conn.outbuf.clear()
        if conn.npending:
            # drop its queued lines so a dead client can't occupy the batch
            remaining = [(c, ln) for c, ln in fifo if c is not conn]
            fifo.clear()
            fifo.extend(remaining)
            conn.npending = 0

    def _dispatch(self, sel, fifo: deque) -> None:
        """Take up to max_batch lines (FIFO across clients), dispatch ONE
        batched search and hand it to the finisher thread; its replies
        route when it completes (_route), while the event loop keeps
        draining sockets."""
        take = min(len(fifo), self._max_batch)
        batch = [fifo.popleft() for _ in range(take)]
        lines = [ln for _, ln in batch]
        pending = dispatch_query_lines(
            lines, backend=self._backend, lenient=self._lenient,
            json_out=self._json, device=self._device,
            mesh=self._mesh)
        self._fin.submit(pending, tag=batch)

    def _route(self, sel, fifo: deque, batch, payload) -> None:
        """Route one completed chunk's replies (main thread: this touches
        the selector and the connections, which the finisher must not)."""
        outputs, nq, dt = payload
        nconns = len({id(c) for c, _ in batch})
        for (conn, _), out in zip(batch, outputs):
            conn.npending = max(0, conn.npending - 1)
            if conn.sock.fileno() < 0:      # vanished mid-batch
                continue
            if out is not None:
                conn.outbuf += out.encode("utf-8", "replace") + b"\n"
            if not conn.outbuf and conn.done():
                self._close(sel, conn, fifo)
            else:
                self._sync_interest(sel, conn, fifo)
        self._served += nq
        if nq:
            self._log(f"[serve] {nq} queries from {nconns} conn(s) in "
                      f"{dt*1e3:.1f} ms ({self._served} total)")

    def _drain_outboxes(self, sel, deadline_s: float = 5.0) -> None:
        """Best-effort flush of answered replies before shutdown."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < deadline_s:
            conns = [k.data for k in sel.get_map().values()
                     if k.data is not None and k.data.outbuf]
            if not conns:
                return
            for conn in conns:
                self._write(sel, conn, deque())
            time.sleep(0.01)


def parse_listen(listen: str):
    """HOST:PORT (PORT alone binds 127.0.0.1) -> (host, port); raises
    ValueError on a bad address."""
    host, sep, port_s = listen.rpartition(":")
    if not sep:
        host, port_s = "127.0.0.1", listen
    try:
        port = int(port_s)
    except ValueError:
        port = -1
    if not 0 <= port <= 65535:
        raise ValueError(f"bad --listen address {listen!r} "
                         "(expected HOST:PORT or PORT)")
    return host or "127.0.0.1", port


def serve_tcp(listen: str, *, backend: str, lenient: bool, json_out: bool,
              device, max_batch: int, quiet: bool, mesh=None,
              finisher: Finisher | None = None) -> int:
    """CLI entry: parse HOST:PORT and run the server on the main thread
    (`finisher`: its finishing thread, made before it; the server closes
    it)."""
    try:
        host, port = parse_listen(listen)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        if finisher is not None:
            finisher.close()
        return 2
    server = TCPQueryServer(host, port, backend=backend, lenient=lenient,
                            json_out=json_out, device=device,
                            max_batch=max_batch, quiet=quiet, mesh=mesh,
                            finisher=finisher)
    return server.run()
