"""Command-line entry point: `psa-torch input.txt -o output.txt`.

Replaces the reference's main.c + orchestrator (main.c:13-56,
cpu_funcs.c:25-121): read input, search, write output, print the wall
time.  `--batch` runs every case record of the input file through the
batch path, one output file each (`-o` names the directory).  `--serve`
answers query lines from stdin, or from TCP clients with `--listen`,
through the same batch path (utils/server.py).  Same output
bytes and exit codes as the JAX package's `psa`: 0 found, 1 no mutation
(the unmodified Seq2 is written with offset -1; in batch mode, any case
without one), 2 bad usage or input, 141 when a serve client closes the
reply pipe.  Runs on the card unless `--device cpu`
or a host backend (`numpy`, `native`) is given.  The reference's runtime
flag (argv[1] = cuda_percentage, main.c:30-42) is `--device-share PCT`: a
split of each query's offsets between the device and the native host
engine (cpu_funcs.c:144-150), with -100 = the sequential oracle mode.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from psa_torch.config import CONFIG

    p = argparse.ArgumentParser(
        prog="psa-torch",
        description="mutant-alignment search on PyTorch/CUDA "
                    "(best single-substitution alignment of Seq2 under Seq1)",
    )
    p.add_argument("input", nargs="?", default=CONFIG.default_input,
                   help="input file: 4 weights, Seq1, Seq2, maximum|minimum "
                        "(default ./input.txt, like the reference def.h:20)")
    p.add_argument("-o", "--output", default=CONFIG.default_output,
                   help="output file (default ./output.txt)")
    p.add_argument("--backend", default=None,
                   choices=["torch", "numpy", "native", "auto", "hybrid"],
                   help="compute path (default torch): torch = the CUDA "
                        "sweep kernel and device epilogue; numpy = the host "
                        "oracle; native = the C++/OpenMP host engine; auto "
                        "= native below the auto threshold of pair-evals, "
                        "torch above it; hybrid = a concurrent device/host "
                        "split of the offsets (see --device-share)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the torch path, also for auto and hybrid "
                        "(cpu runs the kernel's plain PyTorch version)")
    p.add_argument("--device-share", type=float, default=None, metavar="PCT",
                   help="the reference's cuda_percentage (main.c:30-42): "
                        "the device takes the FIRST PCT%% of offsets, the "
                        "native host engine the rest in parallel "
                        "(cpu_funcs.c:144-150); implies --backend hybrid. "
                        "-100 = the sequential oracle mode (native, one "
                        "thread)")
    p.add_argument("--threads", type=int, default=0,
                   help="native-engine thread count (1 = the reference's "
                        "sequential `runseq` mode; 0 = all cores)")
    p.add_argument("--explain", action="store_true",
                   help="render the winning alignment with signs and the "
                        "mutation highlighted (reference pretty_print)")
    p.add_argument("--lenient", action="store_true",
                   help="accept characters outside A-Z/'-' (treated as "
                        "score-0, non-substitutable, like the reference's "
                        "defined out-of-range behavior)")
    p.add_argument("--print-table", action="store_true",
                   help="print the 27x27 sign matrix (reference print_hash)")
    p.add_argument("--case", type=int, default=None, metavar="N",
                   help="run the N-th embedded case record of a scratchpad "
                        "input file (N=0 is the record the reference itself "
                        "would run)")
    p.add_argument("--batch", action="store_true",
                   help="run EVERY embedded case record: queries are "
                        "bucketed by padded shape and streamed through the "
                        "batched device path; -o names a directory "
                        "receiving out_0000.txt, out_0001.txt, ...")
    p.add_argument("--serve", action="store_true",
                   help="streaming serve mode: read one query per stdin line "
                        "(the 7 input-file tokens: 4 weights, Seq1, Seq2, "
                        "mode), write one result line per query to stdout in "
                        "order. Lines already available coalesce into one "
                        "batched device dispatch (up to --serve-batch); a "
                        "malformed line yields an `error ...` line and the "
                        "server keeps going. The input file and -o are "
                        "ignored.")
    p.add_argument("--serve-batch", type=int, default=256, metavar="N",
                   help="max queries coalesced into one dispatch in --serve "
                        "mode (default 256)")
    p.add_argument("--listen", default=None, metavar="HOST:PORT",
                   help="with --serve: answer TCP connections instead of "
                        "stdin; one event loop serves every client, and "
                        "lines from ALL connections coalesce into shared "
                        "device batches; replies return per connection in "
                        "its send order. PORT 0 binds an ephemeral port "
                        "(announced on stderr). Same line protocol as stdin "
                        "serve.")
    p.add_argument("--json", action="store_true",
                   help="print one JSON object to stdout (offset, char "
                        "position, substitute, score, mutant, time) instead "
                        "of the reference-style time trailer; the output "
                        "file is still written (with --serve: one object "
                        "per reply)")
    p.add_argument("--quiet", action="store_true", help="suppress progress prints")
    return p


def _fold_device_share(args) -> str | None:
    """Fold --device-share into --backend and --threads (the JAX package's
    rules); returns an error message, or None."""
    if args.device_share is not None:
        if args.device_share == -100:
            # main.c:33-37: -100 => sequential mode (1 thread, no device)
            args.backend, args.threads, args.device_share = "native", 1, None
        elif 0 <= args.device_share <= 100:
            if args.backend not in (None, "auto", "hybrid"):
                return f"--device-share conflicts with --backend {args.backend}"
            if args.batch or args.serve:
                return ("--device-share applies to single-query searches only "
                        "(the reference splits one query, cpu_funcs.c:144-150)")
            args.backend = "hybrid"
        else:
            return "--device-share must be in [0, 100] or -100"
    if args.backend is None:
        args.backend = "torch"
    if args.backend == "hybrid" and (args.batch or args.serve):
        return "the hybrid backend applies to single-query searches only"
    return None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    err = _fold_device_share(args)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.serve:
        return _main_serve(args)
    if args.batch:
        return _main_batch(args)

    from psa_torch.core.result import NoMutationFound
    from psa_torch.models.search import AlignmentSearchEngine
    from psa_torch.utils.io import read_cases, read_input, write_output

    if args.print_table:
        from psa_torch.utils.pretty import render_sign_table

        print(render_sign_table())

    try:
        if args.case is not None:
            cases = read_cases(args.input)
            if not 0 <= args.case < len(cases):
                print(f"error: --case {args.case} out of range "
                      f"(file has {len(cases)} cases)", file=sys.stderr)
                return 2
            query = cases[args.case]
        else:
            query = read_input(args.input)
    except FileNotFoundError:
        print(f"error: cannot open input file `{args.input}`", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: bad input file `{args.input}`: {e}", file=sys.stderr)
        return 2
    try:
        # device None = the card, which raises when there is none
        engine = AlignmentSearchEngine(
            query.weights, query.is_max, backend=args.backend,
            strict_alphabet=not args.lenient,
            device=None if args.device == "cuda" else args.device,
            nthreads=args.threads, device_share=args.device_share)
    except (RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    try:
        res = engine.search(query.seq1, query.seq2)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except NoMutationFound:
        elapsed = time.perf_counter() - t0
        # Defined behavior where the reference has UB: report explicitly,
        # write the unmodified Seq2 with offset -1.
        print("There are no mutations found", file=sys.stderr)
        write_output(args.output, query.seq2, -1,
                     float("-inf") if query.is_max else float("inf"))
        if args.json:
            print(_result_json(query, None, elapsed))
        elif not args.quiet:
            print("total time: %g" % elapsed)
        return 1
    elapsed = time.perf_counter() - t0

    mutant = res.mutant(query.seq2)
    write_output(args.output, mutant, res.offset, res.score)
    if args.explain:
        from psa_torch.utils.pretty import pretty_print

        pretty_print(query, res)
    if args.json:
        print(_result_json(query, res, elapsed))
    elif not args.quiet:
        # same trailer the reference prints (main.c:46-47)
        print("total time: %g" % elapsed)
    return 0


def _result_json(query, res, elapsed: float | None = None,
                 case: int | None = None) -> str:
    """One machine-readable result object (None result = no mutation)."""
    obj: dict = {}
    if case is not None:
        obj["case"] = case
    obj["mutation_found"] = res is not None
    if res is not None:
        obj.update(offset=res.offset, char_offset=res.char_offset,
                   substitute=res.sub_char, score=res.score,
                   mutant=res.mutant(query.seq2))
    else:
        obj.update(offset=-1, score=(float("-inf") if query.is_max
                                     else float("inf")),
                   mutant=query.seq2)
    if elapsed is not None:
        obj["time_s"] = elapsed
    # json can't carry inf: mirror C printf's 'inf' string for the UB-path
    # score (the %g writer prints 'inf' there too)
    if not np.isfinite(obj["score"]):
        obj["score"] = "%g" % obj["score"]
    return json.dumps(obj)


def _main_batch(args) -> int:
    """Batch mode: run every embedded case record, one output file each."""
    import os

    from psa_torch.models.batch import search_batch
    from psa_torch.utils.io import format_output, read_cases

    try:
        cases = read_cases(args.input)
    except FileNotFoundError:
        print(f"error: cannot open input file `{args.input}`", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: bad input file `{args.input}`: {e}", file=sys.stderr)
        return 2

    outdir = args.output
    if outdir.endswith(".txt"):
        outdir = outdir[: -len(".txt")]
    os.makedirs(outdir, exist_ok=True)

    try:
        device = _batch_device(args)
    except (RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    try:
        results = search_batch(cases, backend=args.backend,
                               strict_alphabet=not args.lenient,
                               device=device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0

    n_missing = 0
    for i, (q, res) in enumerate(zip(cases, results)):
        path = os.path.join(outdir, f"out_{i:04d}.txt")
        with open(path, "w") as f:
            if res is None:
                n_missing += 1
                bad = float("-inf") if q.is_max else float("inf")
                f.write(format_output(q.seq2, -1, bad))
            else:
                f.write(format_output(res.mutant(q.seq2), res.offset,
                                      res.score))
        if args.json:
            print(_result_json(q, res, case=i))
        if args.explain and res is not None:
            from psa_torch.utils.pretty import pretty_print

            print(f"--- case {i} ---", file=sys.stderr)
            pretty_print(q, res, file=sys.stderr)
    if not args.quiet:
        print(f"{len(cases)} cases -> {outdir}/ "
              f"({n_missing} without mutation)", file=sys.stderr)
        if not args.json:
            print("total time: %g" % elapsed)
    # same contract as single-case mode: no-mutation cases signal exit 1
    return 1 if n_missing else 0


def _batch_device(args):
    """The device of the batch and serve paths' device buckets (None for a
    host backend), resolved before any work: "cuda" means the card, which
    raises without one; `native` builds its library first, which raises
    when it cannot be built."""
    if args.backend == "native":
        from psa_torch import native

        native.get_lib()
    if args.backend not in ("torch", "auto"):
        return None
    from psa_torch.models.search import resolve_device

    return resolve_device(None if args.device == "cuda" else args.device)


class _ServeLineReader:
    """Blocking-first, drain-the-rest line reader over a raw fd.

    `next_chunk(max_lines)` blocks until at least one COMPLETE line exists,
    then coalesces every further complete line already available on the fd
    (zero-timeout select + os.read) up to max_lines.  Reading at the fd
    level fixes two hazards of a naive readline/select loop: a partial line
    on the fd can never block the dispatch of complete lines already
    collected (os.read after select-ready cannot block), and lines sitting
    in a stdio readahead buffer are never invisible to the coalescing
    check.  A line longer than one read reassembles in the buffer.  Streams
    without a usable fileno (e.g. StringIO in tests) fall back to one
    blocking readline per chunk.
    """

    def __init__(self, stream):
        self._stream = stream
        self._pending = bytearray()
        self._eof = False
        try:
            self._fd = stream.fileno()
        except (AttributeError, OSError, ValueError):
            # io.UnsupportedOperation is an OSError and a ValueError
            self._fd = None

    def _take_lines(self, out: list, max_lines: int) -> None:
        while len(out) < max_lines:
            nl = self._pending.find(b"\n")
            if nl < 0:
                break
            out.append(self._pending[: nl + 1].decode("utf-8", "replace"))
            del self._pending[: nl + 1]

    def next_chunk(self, max_lines: int):
        """Returns (lines, eof)."""
        if self._fd is None:
            if self._eof:
                return [], True
            line = self._stream.readline()
            if line == "":
                self._eof = True
            return ([line] if line else []), self._eof

        lines: list = []
        # blocking phase: at least one complete line (or EOF)
        while not lines:
            self._take_lines(lines, max_lines)
            if lines or self._eof:
                break
            data = os.read(self._fd, 1 << 16)
            if not data:
                self._eof = True
            else:
                self._pending += data
        # drain phase: whatever is already on the fd, without blocking
        return self._drain(lines, max_lines)

    def poll_chunk(self, max_lines: int, timeout: float = 0.0):
        """Non-blocking next_chunk: complete lines already on the fd,
        waiting at most `timeout` seconds for new bytes.  Used while a
        dispatched chunk computes on the device, so arriving queries join
        the NEXT chunk instead of waiting out a device round trip.  Streams
        without a fileno can't be polled -> ([], eof)."""
        if self._fd is None:
            time.sleep(timeout)     # unpollable stream: honour the wait so
            return [], self._eof    # the device-poll loop doesn't spin
        return self._drain([], max_lines, first_timeout=timeout)

    def _drain(self, lines: list, max_lines: int,
               first_timeout: float = 0.0):
        """Shared drain and EOF-tail rule of next_chunk and poll_chunk:
        pull complete lines already on the fd into `lines`, waiting at most
        `first_timeout` seconds for the FIRST new bytes (0 = pure drain); a
        final unterminated line at EOF is still a query.  Returns (lines,
        eof-and-fully-consumed)."""
        first = True
        while not self._eof and len(lines) < max_lines:
            if b"\n" in self._pending:
                self._take_lines(lines, max_lines)
                continue
            ready, _, _ = select.select([self._fd], [], [],
                                        first_timeout if first else 0)
            first = False
            if not ready:
                break
            data = os.read(self._fd, 1 << 16)
            if not data:
                self._eof = True
            else:
                self._pending += data
        self._take_lines(lines, max_lines)
        if (self._eof and self._pending and b"\n" not in self._pending
                and len(lines) < max_lines):
            lines.append(self._pending.decode("utf-8", "replace"))
            self._pending.clear()
        return lines, self._eof and not self._pending


def _main_serve(args) -> int:
    """Streaming serve mode: stdin query lines -> stdout result lines, or
    TCP clients with --listen (utils/server.serve_tcp).

    The serving analog of the reference's one-shot orchestrator
    (cpu_funcs.c:25-121): the same 7-token query grammar
    (cpu_funcs.c:353-368) and result fields, but long-lived, with results
    streaming back in input order.  The device (the card unless `--device
    cpu` or a host backend) is resolved before any line is read or the
    listening line is printed: without a card this exits 2.

    Result line grammar (stable, machine-parseable by first token):
      `<offset> <score%g> <mutant>`   mutation found
      `-1 <inf|-inf> <seq2>`          no legal mutation
      `error <message>`               malformed query line (server keeps going)
    Blank lines are ignored.  --json swaps result lines for JSON objects.
    A failure of the device path ends the loop with an `error:` line and
    exit 1; no host engine answers in its place.
    """
    if args.listen is not None:
        from psa_torch.utils.server import parse_listen

        try:
            parse_listen(args.listen)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    try:
        device = _batch_device(args)
    except (RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        if args.listen is not None:
            from psa_torch.utils.server import serve_tcp

            rc = serve_tcp(args.listen, backend=args.backend,
                           lenient=args.lenient, json_out=args.json,
                           device=device, max_batch=args.serve_batch,
                           quiet=args.quiet)
        else:
            rc = _serve_loop(args, _ServeLineReader(sys.stdin), device)
    except (RuntimeError, OSError, ValueError) as e:
        # a failed build, launch or fetch on the device: the server stops
        # rather than answer from another engine
        print(f"error: serving failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    if not args.quiet:
        print("total time: %g" % (time.perf_counter() - t_start),
              file=sys.stderr)
    return rc


def _serve_loop(args, reader, device) -> int:
    """The chunk loop of `_main_serve`; returns the process exit code.

    Pipelined: up to `CONFIG.serve_inflight` chunks may be dispatched but
    unfinished, and while the oldest computes on the device the loop keeps
    draining stdin (reader.poll_chunk), so arriving queries join the NEXT
    chunk instead of waiting out a device round trip.  Replies print
    strictly in input order (chunks finish FIFO).  A partial chunk
    dispatches only once the pipeline is empty: while the device is busy, a
    trickle accumulates into a fuller chunk."""
    from psa_torch.config import CONFIG
    from psa_torch.utils.server import Finisher, dispatch_query_lines

    max_b = max(1, args.serve_batch)
    depth = max(1, CONFIG.serve_inflight)
    served = 0
    queued: list = []
    eof = False
    fin = Finisher()               # fetches complete FIFO off the loop

    def flush(payload) -> int:
        nonlocal served
        outputs, nq, dt = payload
        try:
            for o in outputs:
                if o is not None:
                    print(o)
            sys.stdout.flush()
        except BrokenPipeError:
            # the client went away: a server exits quietly (128+SIGPIPE),
            # it doesn't traceback
            if not args.quiet:
                print("[serve] client closed the reply pipe; exiting",
                      file=sys.stderr)
            try:
                # park stdout on /dev/null so the interpreter's final
                # flush can't raise a second EPIPE
                os.dup2(os.open(os.devnull, os.O_WRONLY),
                        sys.stdout.fileno())
            except (AttributeError, OSError, ValueError):
                pass                # a stdout without an fd (tests)
            return 141
        served += nq
        if not args.quiet and nq:
            print(f"[serve] {nq} queries in {dt*1e3:.1f} ms "
                  f"({served} total)", file=sys.stderr)
        return 0

    abandon = True
    try:
        while True:
            # dispatch: a full chunk whenever the pipeline has room; a
            # partial one only once the pipeline is empty
            while (fin.inflight < depth
                   and (len(queued) >= max_b
                        or (queued and not fin.inflight))):
                take = queued[:max_b]
                del queued[:max_b]
                fin.submit(dispatch_query_lines(
                    take, backend=args.backend, lenient=args.lenient,
                    json_out=args.json, device=device))
            if not fin.inflight:
                if eof:
                    break
                lines, eof = reader.next_chunk(max_b)  # idle: block
                queued.extend(lines)
                continue
            # print whatever the finisher thread completed; block outright
            # only when nothing else can progress (pipeline full, or the EOF
            # endgame with no full chunk left to form)
            block = (fin.inflight >= depth
                     or (eof and len(queued) < max_b))
            got = fin.collect(timeout=None if block else 0)
            if got is not None:
                rc = flush(got[1])
                if rc:
                    # broken pipe: nobody reads further replies; exit
                    # without waiting for in-flight fetches
                    return rc
                continue
            # oldest chunk still in flight and the pipeline has room: drain
            # stdin while the finisher waits on the fetch
            lines, got_eof = reader.poll_chunk(max_b - len(queued),
                                               timeout=0.002)
            eof = eof or got_eof
            queued.extend(lines)
        abandon = False
    finally:
        # after a broken pipe or a failure nobody waits for in-flight work
        fin.close(wait=not abandon)
    return 0


if __name__ == "__main__":
    sys.exit(main())
