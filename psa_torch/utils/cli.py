"""Command-line entry point: `psa-torch input.txt -o output.txt`.

Replaces the reference's main.c + orchestrator (main.c:13-56,
cpu_funcs.c:25-121): read input, search, write output, print the wall
time.  `--batch` runs every case record of the input file through the
batch path, one output file each (`-o` names the directory).  `--serve`
answers query lines from stdin, or from TCP clients with `--listen`,
through the same batch path (utils/server.py).  `--sharded` splits a
query's offsets (or, with `--batch` and `--serve`, each microbatch's
queries) over every card (parallel/mesh.py); `--distributed` runs one rank
of a Gloo process group (parallel/multihost.py; `psa-torch-dist -np N`
starts N of them).  Same output
bytes and exit codes as the JAX package's `psa`: 0 found, 1 no mutation
(the unmodified Seq2 is written with offset -1; in batch mode, any case
without one), 2 bad usage or input, 141 when a serve client closes the
reply pipe.  Runs on the card unless `--device cpu`
or a host backend (`numpy`, `native`) is given.  The reference's runtime
flag (argv[1] = cuda_percentage, main.c:30-42) is `--device-share PCT`: a
split of each query's offsets between the device and the native host
engine (cpu_funcs.c:144-150), with -100 = the sequential oracle mode.
`--trace LOGDIR` records a torch.profiler trace of the search, the batch or
the serve loop into LOGDIR (utils/profiling.trace).
"""

from __future__ import annotations

import argparse
import contextlib
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
                   choices=["torch", "numpy", "native", "auto", "hybrid",
                            "xla", "conv"],
                   help="compute path (default torch): torch = the CUDA "
                        "sweep kernel and device epilogue; numpy = the host "
                        "oracle; native = the C++/OpenMP host engine; auto "
                        "= native below the auto threshold of pair-evals, "
                        "torch above it; hybrid = a concurrent device/host "
                        "split of the offsets (see --device-share); xla = "
                        "the chunked gather engine and conv = the one-hot "
                        "convolution engine, both differential references "
                        "on the device")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the torch path, also for auto, hybrid, "
                        "xla and conv (cpu runs the kernel's plain PyTorch "
                        "version)")
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
    p.add_argument("--warmup", metavar="FILE", default=None,
                   help="with --serve: before serving starts, run one chunk "
                        "of dummy queries through the serve path for each "
                        "(weights, mode, shape bucket) of the query lines in "
                        "FILE, so the first replies do not pay the kernel "
                        "library's build or load, the CUDA context, each "
                        "kernel's first launch, the device tables or the "
                        "first device and pinned blocks. Every weight "
                        "vector is warmed (the device tables are per "
                        "weights). A failed warmup exits 1 before any "
                        "reply. By default only the FULL-chunk batch size "
                        "is warmed (see --warmup-sizes)")
    p.add_argument("--warmup-sizes", default="chunk", metavar="SPEC",
                   help="batch sizes to warm per --warmup bucket: `chunk` "
                        "(default: one full --serve-batch chunk), `ladder` "
                        "(every power of two 1..chunk), or a comma list of "
                        "sizes (e.g. `64,256`), each clamped to "
                        "[1, --serve-batch]")
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
    p.add_argument("--trace", metavar="LOGDIR", default=None,
                   help="capture a torch.profiler trace (host operators and "
                        "the card's kernels) of the search, the batch or the "
                        "serve loop into LOGDIR, as "
                        "<host>_<pid>.<timestamp>.pt.trace.json")
    p.add_argument("--sharded", action="store_true",
                   help="shard the offset axis over every local card (the "
                        "mesh shape chosen per query; PSA_MESH_SHAPE="
                        "n_op,n_ch overrides); with --batch or --serve, "
                        "shard each microbatch's queries over them; "
                        "--device cpu is a mesh of one CPU device")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run (the reference's `make run` = "
                        "mpiexec, Makefile:18-22): join a Gloo process "
                        "group, process 0 reads and writes the files, the "
                        "query broadcasts and its offsets shard over every "
                        "rank (with --batch, the cases split over the "
                        "ranks). Launch via psa-torch-dist, torchrun, or "
                        "one process per rank with the three flags below.")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="the process group's rendezvous address (rank 0 "
                        "listens there)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for --distributed")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for --distributed")
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
            if args.batch or args.serve or args.sharded or args.distributed:
                return ("--device-share applies to single-query searches only "
                        "(the reference splits one query, cpu_funcs.c:144-150)")
            args.backend = "hybrid"
        else:
            return "--device-share must be in [0, 100] or -100"
    if args.backend is None:
        args.backend = "torch"
    if args.backend == "hybrid" and (args.batch or args.serve or args.sharded
                                     or args.distributed):
        return "the hybrid backend applies to single-query searches only"
    return None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    err = _fold_device_share(args)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.distributed:
        return _main_distributed(args)
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
        if args.sharded:
            # the mesh of every card (or of the one CPU device), resolved
            # first: without a card this exits 2
            mesh = _mesh(args)
            kernel = _sharded_kernel(args.backend)
        else:
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
        with _tracer(args):
            if args.sharded:
                from psa_torch.core.alphabet import encode, ensure_valid
                from psa_torch.core.tables import build_tables_cached
                from psa_torch.parallel.mesh import search_sharded_auto

                ensure_valid(query.seq1, query.seq2, args.lenient)
                # the mesh shape chosen per query; PSA_MESH_SHAPE overrides
                res = search_sharded_auto(
                    encode(query.seq1), encode(query.seq2),
                    build_tables_cached(np.asarray(query.weights, np.float64),
                                        query.is_max), mesh, kernel=kernel)
            else:
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
        mesh = _batch_mesh(args)
    except (RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    try:
        with _tracer(args):
            results = search_batch(cases, backend=args.backend,
                                   strict_alphabet=not args.lenient,
                                   device=device, mesh=mesh)
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
    """The device of the batch and serve paths' device buckets and of the
    xla and conv engines (None for a host backend), resolved before any
    work: "cuda" means the card, which raises without one; `native` builds
    its library first, which raises when it cannot be built."""
    if args.backend == "native":
        from psa_torch import native

        native.get_lib()
    from psa_torch.models.search import DEVICE_BACKENDS, resolve_device

    if args.backend not in DEVICE_BACKENDS:
        return None

    return resolve_device(None if args.device == "cuda" else args.device)


def _tracer(args):
    """`--trace LOGDIR`'s profiler around a path (utils/profiling.trace),
    recording the card's kernels unless the run stays on the host; a null
    context without --trace, which imports no profiler."""
    if not args.trace:
        return contextlib.nullcontext()
    from psa_torch.utils.profiling import trace

    on_card = args.device != "cpu" and args.backend not in ("numpy", "native")
    return trace(args.trace, cuda=on_card)


def _mesh(args) -> list:
    """--sharded's mesh: every card (raises without one), or the one CPU
    device with --device cpu."""
    from psa_torch.parallel.mesh import make_mesh

    return make_mesh(["cpu"] if args.device == "cpu" else None)


def _batch_mesh(args):
    """--sharded in batch and serve mode: the mesh the device buckets shard
    their queries over (models/batch.batched_search_exact_sharded); None
    without --sharded."""
    return _mesh(args) if args.sharded else None


def _sharded_kernel(backend: str) -> str:
    """The per-shard kernel of the sharded and distributed single-query
    paths (parallel/mesh.py `kernel=`): `torch` and `auto` run the CUDA
    sweep (csrc/sweep.cu, kernel "auto") on each shard, `xla` the gather
    engine (ops/engine_xla.py).  The other backends have no sharded path:
    they warn and the shards run the sweep, where the JAX package coerces
    them to its xla kernel (psa_tpu/utils/cli.py `_sharded_kernel`)."""
    if backend == "xla":
        return "xla"
    if backend not in ("torch", "auto"):
        print(f"warning: backend {backend!r} has no sharded path; "
              "using the torch kernel", file=sys.stderr)
    return "auto"


def _main_distributed(args) -> int:
    """Multi-process flow: join the process group, run the distributed
    search (parallel/multihost.py).  Every rank runs the same program;
    process 0 owns file I/O and the time trailer.  Exit codes as one
    process's: 2 for a card missing without --device cpu, a group that
    cannot be joined, or a bad input (on every rank), 1 for no mutation or
    a failed device or collective."""
    import torch

    from psa_torch.parallel import multihost

    if args.device != "cpu" and not torch.cuda.is_available():
        print("error: no CUDA device available; pass --device cpu to run "
              "on the host", file=sys.stderr)
        return 2
    try:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, force=True)
    except Exception as e:  # noqa: BLE001 - no group to join
        print(f"error: cannot join a process group ({type(e).__name__}: "
              f"{e}); pass --coordinator/--num-processes/--process-id "
              "explicitly or launch via psa-torch-dist", file=sys.stderr)
        return 2
    try:
        return _run_distributed(args, multihost)
    finally:
        multihost.shutdown()


def _run_distributed(args, multihost) -> int:
    """The body of `_main_distributed` inside the process group."""
    import torch.distributed as dist

    from psa_torch.models.search import DEVICE_BACKENDS

    device = multihost.rank_device(args.device)
    if not args.quiet:
        world, rank = multihost.process_layout()
        backend = dist.get_backend() if dist.is_initialized() else "none"
        print(f"[dist] rank {rank} of {world}: device {device}, "
              f"group backend {backend}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
        if args.batch:
            outdir = args.output
            if outdir.endswith(".txt"):
                outdir = outdir[: -len(".txt")]
            code = multihost.run_distributed_batch(
                args.input, outdir, backend=args.backend,
                lenient=args.lenient, quiet=args.quiet, json_out=args.json,
                shard_local=args.sharded,
                device=(device if args.backend in DEVICE_BACKENDS
                        else None))
        else:
            code = multihost.run_distributed_search(
                args.input, args.output,
                backend_kernel=_sharded_kernel(args.backend),
                lenient=args.lenient, mesh=[device])
    except FileNotFoundError:
        print(f"error: cannot open input file `{args.input}`", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:
        # a failed build, launch or collective: this rank stops, and the
        # others fail within the group's timeout
        print(f"error: distributed run failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    if multihost.is_primary() and not args.quiet and not (
            args.batch and args.json):
        print("total time: %g" % (time.perf_counter() - t0))
    return code


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
        mesh = _batch_mesh(args)
    except (RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    fin = None
    if args.warmup:
        from psa_torch.utils.server import Finisher

        # the serve loop's finishing thread, made first: the warmup's chunks
        # finish on it, as the clients' chunks will
        fin = Finisher()
        rc = _serve_warmup(args, device, mesh, fin)
        if rc:
            fin.close()
            return rc
    t_start = time.perf_counter()
    try:
        with _tracer(args):
            if args.listen is not None:
                from psa_torch.utils.server import serve_tcp

                rc = serve_tcp(args.listen, backend=args.backend,
                               lenient=args.lenient, json_out=args.json,
                               device=device, max_batch=args.serve_batch,
                               quiet=args.quiet, mesh=mesh, finisher=fin)
            else:
                rc = _serve_loop(args, _ServeLineReader(sys.stdin), device,
                                 mesh, fin)
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


def _warmup_sizes(spec: str, chunk: int) -> list | None:
    """--warmup-sizes SPEC -> the batch sizes to warm per bucket: `chunk`,
    `ladder` (the powers of two below chunk, then chunk) or a comma list,
    each clamped to [1, chunk]; None for a bad spec."""
    if spec == "chunk":
        return [chunk]
    if spec == "ladder":
        sizes, s = [], 1
        while s < chunk:
            sizes.append(s)
            s *= 2
        return sizes + [chunk]
    try:
        return sorted({max(1, min(int(x), chunk))
                       for x in spec.split(",") if x.strip()})
    except ValueError:
        return None


def _serve_warmup(args, device, mesh, fin=None) -> int:
    """--warmup FILE: before the first reply (and the listening line), run
    a chunk of dummy queries through the serve path for each (weights,
    mode, `bucket_shape`) of FILE's query lines and each --warmup-sizes
    batch size: on `torch` and `auto` through models/batch.warm_fused_runner
    (after warm_kernels has launched each of the path's kernels once), on
    the shared-Seq1 kernel as well when all of a bucket's lines share Seq1;
    on the other backends through search_batch_async on that backend, as
    their chunks run (`numpy` and `native` touch no card).  Each chunk is
    dispatched here and finished on `fin` (utils/server.Finisher), the
    serve loop's finishing thread, when one is given.  The JAX package's
    `_serve_warmup` with two differences: every weight vector is warmed,
    where the JAX package skips a second one on a (mode, shape) it has
    compiled (its runners are weights-generic; the port's device tables
    are per weights), and a failure exits 1 with an `error:` line instead
    of leaving the bucket to a host engine.  Returns the exit code: 0, 2
    for an unreadable file or a bad --warmup-sizes, 1 for a failed
    warmup."""
    from psa_torch.core.tables import build_tables_cached
    from psa_torch.models import batch
    from psa_torch.ops.sweep import bucket_shape
    from psa_torch.utils.io import parse_query_lines

    try:
        with open(args.warmup) as f:
            lines = f.read().splitlines()
    except OSError as e:
        print(f"error: cannot read --warmup file `{args.warmup}`: {e}",
              file=sys.stderr)
        return 2
    buckets: dict = {}
    for j, ent in enumerate(parse_query_lines(lines,
                                              check_alphabet=not args.lenient)):
        if ent is None:
            continue
        if isinstance(ent, str):
            print(f"warning: --warmup line {j + 1} skipped: {ent}",
                  file=sys.stderr)
            continue
        l1k, l2p = bucket_shape(len(ent.seq1), len(ent.seq2))
        buckets.setdefault(
            (tuple(float(x) for x in ent.weights), ent.is_max, l1k, l2p),
            []).append(ent.seq1)
    spec = args.warmup_sizes or "chunk"
    sizes = _warmup_sizes(spec, max(1, args.serve_batch))
    if sizes is None:
        print(f"error: bad --warmup-sizes `{spec}` (use `chunk`, `ladder`, "
              "or a comma list of ints)", file=sys.stderr)
        return 2
    on_device = args.backend in ("torch", "auto")
    finish = fin.call if fin is not None else (lambda f: f())
    t_all = time.perf_counter()
    try:
        for n, ((w, is_max, l1k, l2p), s1s) in enumerate(buckets.items()):
            tables = build_tables_cached(np.asarray(w), is_max)
            if on_device and n == 0:
                t0 = time.perf_counter()
                batch.warm_kernels(tables, device, mesh, finish)
                _warmup_log(args, "kernels built or loaded and launched", t0)
            # a bucket whose lines all share Seq1 dispatches through the
            # shared-Seq1 kernel: warm it AND the plain one (mixed chunks)
            shared = len(s1s) > 1 and all(s == s1s[0] for s in s1s[1:])
            for b in sizes:
                for shared_s1 in ((False, True) if shared and b > 1
                                  else (False,)):
                    t0 = time.perf_counter()
                    if on_device:
                        batch.warm_fused_runner(tables, b, l1k, l2p, device,
                                                mesh=mesh, shared_s1=shared_s1,
                                                finish=finish)
                    else:
                        finish(batch.search_batch_async(
                            _warm_queries(tables, b, l1k, l2p, shared_s1),
                            backend=args.backend, device=device)[1])
                    _warmup_log(args, f"bucket B={b} l1k={l1k} l2p={l2p} "
                                f"{'max' if is_max else 'min'}"
                                f"{' shared Seq1' if shared_s1 else ''} "
                                "warmed", t0)
    except (RuntimeError, OSError, ValueError) as e:
        # no host engine answers in the device's place, so a path that
        # cannot be warmed cannot serve either
        print(f"error: warmup failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    if buckets:
        _warmup_log(args, f"{len(buckets)} bucket(s) warmed", t_all)
    return 0


def _warmup_log(args, what: str, t0: float) -> None:
    if not args.quiet:
        print(f"[warmup] {what} in {time.perf_counter() - t0:.3f}s",
              file=sys.stderr, flush=True)


def _warm_queries(tables, b: int, l1k: int, l2p: int,
                  shared_s1: bool) -> list:
    """models/batch.warm_rows' dummy queries as Query objects, for a chunk
    on a host or per-query backend."""
    from psa_torch.core.alphabet import decode
    from psa_torch.models.batch import warm_rows
    from psa_torch.utils.io import Query

    c1b, c2b, noffs, n2s = warm_rows(b, l1k, l2p, shared_s1)
    return [Query(tables.weights, decode(c1[: noff + n2 - 1]),
                  decode(c2[:n2]), tables.is_max)
            for c1, c2, noff, n2 in zip(c1b, c2b, noffs, n2s)]


def _serve_loop(args, reader, device, mesh=None, fin=None) -> int:
    """The chunk loop of `_main_serve`; returns the process exit code.

    Pipelined: up to `CONFIG.serve_inflight` chunks may be dispatched but
    unfinished, and while the oldest computes on the device the loop keeps
    draining stdin (reader.poll_chunk), so arriving queries join the NEXT
    chunk instead of waiting out a device round trip.  Replies print
    strictly in input order (chunks finish FIFO).  A partial chunk
    dispatches only once the pipeline is empty: while the device is busy, a
    trickle accumulates into a fuller chunk.  `fin`: the finishing thread
    (utils/server.Finisher), when the warmup made it; the loop closes it."""
    from psa_torch.config import CONFIG
    from psa_torch.utils.server import Finisher, dispatch_query_lines

    max_b = max(1, args.serve_batch)
    depth = max(1, CONFIG.serve_inflight)
    served = 0
    queued: list = []
    eof = False
    fin = fin or Finisher()        # fetches complete FIFO off the loop

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
                    json_out=args.json, device=device, mesh=mesh))
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
