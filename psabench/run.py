"""Run one cell of the benchmark once and print its result line.

    python -m psabench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `psa_torch`.  The run makes its
inputs from the seed, builds the configuration's entry on the card, warms
it with calls of the cell's own shape (set-up), drives the traffic back to
back for `--seconds` (the window), then checks every answer the window
returned against the plain reference (reference.py) and prints, as the last
line of standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`, each
number compared beside its limit (also the last lines of standard error).
With `--trace 0` the metrics are the end-to-end ones; with `--trace 1` the
per-layer ones, read from the harness's spans and one profile of a steady
part of the window.

Without as many CUDA devices as the cell asks for it exits 2 and prints no
result; it never runs on the CPU.  It exits 3, with no result, when JAX, its
libraries or the JAX package were loaded.
"""

import time

_T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "psa_tpu")
PROFILE_FROM = 0.3          # share of the window before the profile starts
PROFILE_SECONDS = 2.0       # it records at least this long from its start
PROFILE_REQUESTS = 8        # ... and at least this many requests
CHECKOUT = Path(__file__).resolve().parent.parent


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a metric module reads (metrics/*.py)."""

    cell: dict
    config: dict
    mix: dict
    setup_s: float
    requests: list
    window_s: float
    pairs_per_call: int
    queries_per_call: int
    floor_s_per_call: float
    spans: list | None = None       # per request: {span: seconds}
    trace: object | None = None     # trace.Trace of the profiled requests
    traced_requests: int = 0


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             t0: float, mix_override: dict | None = None,
             log=lambda line: print(line, file=sys.stderr)) -> dict:
    """One run of `cell` on `device`; returns the result object.  `t0` is
    the host clock at the process's start; `mix_override` replaces
    parameters of the traffic mix (the tests' small sizes)."""
    import torch

    from psabench import check, reference, registry, roofline
    from psabench.spans import Spans, installed

    config = registry.config(cell["config"])
    mix = dict(registry.traffic(cell["traffic"]), **(mix_override or {}))
    driver = registry.driver(mix["kind"])
    entry_mod = registry.entry(config["entry"])
    cuda = device.type == "cuda"

    pool = driver.make_pool(mix, seed)
    entry = entry_mod.Entry(config, device)
    prepared = [entry.prepare(call) for call in pool]
    driver.warm(entry, prepared, mix)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    spans = prof = None
    state = {"on": False, "done": False, "since": 0.0, "n": 0}
    scope = contextlib.ExitStack()
    if traced:
        from psabench.trace import Profile

        spans = Spans(device)
        scope.enter_context(installed(spans, entry_mod.SPANS))
        prof = Profile(device)

        def before(elapsed):
            """Between two requests: start the profiler once, PROFILE_FROM
            into the window, and stop it once it has recorded
            PROFILE_SECONDS and PROFILE_REQUESTS (or the window ends);
            True when the next request is recorded."""
            if state["on"] and (elapsed is None or (
                    time.perf_counter() - state["since"] >= PROFILE_SECONDS
                    and state["n"] >= PROFILE_REQUESTS)):
                prof.stop()
                state["on"], state["done"] = False, True
            elif (not state["on"] and not state["done"]
                  and elapsed is not None
                  and elapsed >= PROFILE_FROM * seconds):
                prof.start()
                state["on"], state["since"] = True, time.perf_counter()
            state["n"] += state["on"]
            return state["on"]
    else:
        before = None
    with scope:
        requests = driver.drive(entry, prepared, seconds, before,
                                spans.request if spans else None)
    window_s = requests[-1].t1 - requests[0].t0 if requests else 0.0
    memory_peak = (int(torch.cuda.max_memory_allocated(device)) if cuda
                   else 0)

    per_call = len(pool[0])
    ctx = Context(cell, config, mix, setup_s, requests, window_s,
                  driver.pairs_per_call(mix), per_call,
                  per_call * roofline.floor_s(int(mix["seq1_len"]),
                                              int(mix["seq2_len"])))
    if traced:
        ctx.spans = [s for s, r in zip(spans.per_request, requests)
                     if not r.profiled]
        ctx.trace = prof.trace
        ctx.traced_requests = sum(r.profiled for r in requests)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in registry.metrics():
        name = registry.metric_name(m)
        if m.KIND != kind or cell["name"] not in getattr(
                m, "WORKLOADS", (cell["name"],)):
            continue
        value = m.read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": m.UNIT}

    done = [r.seconds * 1e3 for r in requests if r.results is not None]
    if done:
        import numpy as np

        log(f"requests: {len(done)} completed of {len(requests)} in "
            f"{window_s:.3f} s; median {float(np.median(done)):.4f} ms, "
            f"p95 {float(np.percentile(done, 95)):.4f} ms")
    errors = [r.error for r in requests if r.error]
    if errors:
        log(f"{len(errors)} requests failed; the first: {errors[0]}")
    if prof is not None:
        log(f"profile: {ctx.traced_requests} requests, "
            f"{prof.bytes} bytes of trace")

    # the program's state goes before the reference runs on the same card
    del entry, prepared
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    tables = reference.Tables(config["weights"], config["mode"] == "maximum")
    answers = check.reference_answers(pool, {r.call for r in requests},
                                      tables, device)
    numbers = check.compare(requests, answers)
    log(f"reference: {sum(len(a) for a in answers.values())} queries in "
        f"{time.perf_counter() - r0:.3f} s")

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": check.verdict(numbers), "attempted": len(requests),
              "failed": sum(r.results is None for r in requests),
              "metrics": metrics, "device": dev}
    if traced and ctx.trace is not None:
        w = ctx.trace.window_us()
        dev["busy_s"] = ctx.trace.busy_us() * 1e-6
        dev["window_s"] = (w[1] - w[0]) * 1e-6 if w else 0.0
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    for line in check.lines(numbers):
        log(line)
    result["checks"] = check.as_json(numbers)
    return result


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m psabench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from psabench import registry

    cell = registry.cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"psabench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}. No result.",
              file=sys.stderr)
        return 2
    try:
        import psa_torch
    except ImportError as e:
        print(f"psabench: the program is missing ({e}). No result.",
              file=sys.stderr)
        return 2
    where = Path(psa_torch.__file__).resolve().parent.parent
    if where != CHECKOUT:
        print(f"psabench: psa_torch comes from {where}, not from this "
              f"checkout ({CHECKOUT}). No result.", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), _T0)
    found = forbidden_modules()
    if found:
        print(f"psabench: loaded {', '.join(found)}; the benchmark runs "
              "without JAX and the JAX package. No result.", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
