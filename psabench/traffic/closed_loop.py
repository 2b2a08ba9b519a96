"""A closed loop: one caller sending its next request when the last one has
returned, back to back, through a pool of distinct calls made from the
seed.

A mix of this kind (traffic/<mix>.json) gives:
  seq1_len, seq2_len   every query's lengths (the same in every run)
  per_call             queries in one request
  shared_seq1          the queries of a call share one Seq1 (default false)
  pool                 distinct calls a run cycles through, in order
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

from psabench import generator, roofline

# calls of the cell's own shape made in set-up: the first loads the
# library, the context and the kernels, the second finds every cache warm
WARMUP_CALLS = 2


@dataclasses.dataclass
class Request:
    call: int              # index into the pool
    t0: float              # host clock at the call
    t1: float              # host clock at its return, results on the host
    results: list | None   # None when the call raised
    error: str = ""
    profiled: bool = False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def check_mix(mix: dict) -> None:
    n1, n2 = int(mix["seq1_len"]), int(mix["seq2_len"])
    if not 0 < n2 <= n1 or int(mix["per_call"]) < 1 or int(mix["pool"]) < 1:
        raise ValueError(f"bad closed_loop mix {mix}")


def make_pool(mix: dict, seed: int) -> list:
    """The run's distinct calls: lists of (seq1, seq2)."""
    check_mix(mix)
    return generator.make_calls(seed, int(mix["pool"]), int(mix["per_call"]),
                                int(mix["seq1_len"]), int(mix["seq2_len"]),
                                bool(mix.get("shared_seq1", False)))


def pairs_per_call(mix: dict) -> int:
    return int(mix["per_call"]) * roofline.pairs(int(mix["seq1_len"]),
                                                 int(mix["seq2_len"]))


def warm(call, prepared: list, mix: dict) -> None:
    """The set-up's calls: WARMUP_CALLS calls of the pool's shape."""
    for k in range(WARMUP_CALLS):
        call(prepared[k % len(prepared)])


def drive(call, prepared: list, seconds: float, before=None,
          request_scope=None) -> list:
    """Call back to back until `seconds` have passed since the first call;
    the last call runs to its end.  `before(elapsed)` runs between two
    requests (where a traced run starts and stops its profiler) and returns
    whether the next request is profiled; `request_scope()` is a context
    around each request.  Returns every Request in order."""
    out: list = []
    start = time.perf_counter()
    k = 0
    while True:
        now = time.perf_counter()
        if now - start >= seconds:
            break
        profiled = bool(before(now - start)) if before else False
        i = k % len(prepared)
        scope = request_scope() if request_scope else contextlib.nullcontext()
        with scope:
            t0 = time.perf_counter()
            try:
                res, err = call(prepared[i]), ""
            except Exception as e:  # noqa: BLE001 - a failed request is counted
                res, err = None, f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
        out.append(Request(i, t0, t1, res, err, profiled))
        k += 1
    if before:
        before(None)
    return out

