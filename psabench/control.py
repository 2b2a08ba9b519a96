"""The control of the comparison that decides `correct`: the reference put
in the program's place with one thing broken, which the check must refuse.

    python -m psabench.control --workload <cell> --seeds 1 2 3 [--variant V]

For each seed it makes the cell's pool of calls at the cell's own sizes
(the traffic mix as it stands), answers every query with the control, and
compares the answers with the reference's exactly as a run does
(check.compare).  One JSON line a seed and variant.  Variants:

  last_position  the substitution at the last position of the best gain
                 rather than the first: the tie order the configuration
                 states (strict improvement, cpu_funcs.c:287-288) broken.
  float32        the totals summed in float32, the precision below the
                 upstream's double: with integer weights and Seq2 below
                 2**24 / max|w| every total is an integer float32 holds, so
                 this one reads as the reference does (PERF.md says why).

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

VARIANTS = {
    "last_position": {"position": "last"},
    "float32": {"dtype": "float32"},
}


def control_answers(pool: list, tables, device, variant: str) -> dict:
    """{pool index: [control answer per query]}."""
    import torch

    from psabench import reference

    kw = dict(VARIANTS[variant])
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, kw["dtype"])
    return {i: [reference.winner(s1, s2, tables, device, **kw)
                for s1, s2 in call] for i, call in enumerate(pool)}


def run_control(cell_name: str, seed: int, variant: str, device,
                mix_override: dict | None = None) -> dict:
    from psabench import check, reference, registry
    from psabench.traffic.closed_loop import Request

    cell = registry.cell(cell_name)
    config = registry.config(cell["config"])
    mix = dict(registry.traffic(cell["traffic"]), **(mix_override or {}))
    pool = registry.driver(mix["kind"]).make_pool(mix, seed)
    tables = reference.Tables(config["weights"], config["mode"] == "maximum")
    t0 = time.perf_counter()
    got = control_answers(pool, tables, device, variant)
    want = check.reference_answers(pool, set(got), tables, device)
    numbers = check.compare([Request(i, 0.0, 0.0, a) for i, a in got.items()],
                            want)
    return {"workload": cell_name, "seed": seed, "variant": variant,
            **numbers, "correct": check.verdict(numbers),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m psabench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", choices=sorted(VARIANTS), nargs="+",
                   default=sorted(VARIANTS))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("psabench.control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        for v in args.variant:
            print(json.dumps(run_control(args.workload, seed, v, dev)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
