"""Command-line entry point: `psa-torch input.txt -o output.txt`.

Replaces the reference's main.c + orchestrator (main.c:13-56,
cpu_funcs.c:25-121): read input, search, write output, print the wall
time.  `--batch` runs every case record of the input file through the
batch path, one output file each (`-o` names the directory).  Same output
bytes and exit codes as the JAX package's `psa`: 0 found, 1 no mutation
(the unmodified Seq2 is written with offset -1; in batch mode, any case
without one), 2 bad usage or input.  Runs on the card unless `--device cpu`
or a host backend (`numpy`, `native`) is given.  The reference's runtime
flag (argv[1] = cuda_percentage, main.c:30-42) is `--device-share PCT`: a
split of each query's offsets between the device and the native host
engine (cpu_funcs.c:144-150), with -100 = the sequential oracle mode.
"""

from __future__ import annotations

import argparse
import json
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
    p.add_argument("--json", action="store_true",
                   help="print one JSON object to stdout (offset, char "
                        "position, substitute, score, mutant, time) instead "
                        "of the reference-style time trailer; the output "
                        "file is still written")
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
            if args.batch:
                return ("--device-share applies to single-query searches only "
                        "(the reference splits one query, cpu_funcs.c:144-150)")
            args.backend = "hybrid"
        else:
            return "--device-share must be in [0, 100] or -100"
    if args.backend is None:
        args.backend = "torch"
    if args.backend == "hybrid" and args.batch:
        return "the hybrid backend applies to single-query searches only"
    return None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    err = _fold_device_share(args)
    if err is not None:
        print(f"error: {err}", file=sys.stderr)
        return 2
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
    from psa_torch.models.search import resolve_device
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

    device = None
    try:
        if args.backend in ("torch", "auto"):
            # "cuda" = the card, which raises when there is none
            device = resolve_device(None if args.device == "cuda"
                                    else args.device)
        if args.backend == "native":
            from psa_torch import native

            native.get_lib()
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


if __name__ == "__main__":
    sys.exit(main())
