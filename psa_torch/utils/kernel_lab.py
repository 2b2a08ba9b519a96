"""Kernel lab: time the sweep variants on the card.

    python -m psa_torch.utils.kernel_lab [--variant v1|v2|v3] [--n1 131072]
        [--n2 8192] [--iters 16] [--check] [--device cuda|cpu]

v1 is `ops/sweep.sweep` (the shared-memory table route), v2 and v3 the
tensor-core sweeps of ops/_sweep_v2.py and ops/_sweep_v3.py.  The inputs are
`random_sequences(n1, n2, seed=0)`, weights 1 3 4 2, minimum.  `--check`
holds the variant's `offset_stats` against `core/oracle.offset_stats_numpy`
and exits 1 on a mismatch.  The time is CUDA events around `--iters`
back-to-back launches on a warm library, launch i taking Seq2 rolled by i
(the rolls are uploaded before the timed window).  Progress goes to stderr;
the last line of stdout is `RESULT <variant> <tile> <chunk> <ms>`.

Runs on the card; without one it exits 2.  `--device cpu` runs the plain
versions and times them on the host clock, a CPU number.  The Hopper
kernels' tile and chunk are compile-time constants, so the JAX lab's
`--tile` and `--chunk` have no counterpart (the RESULT line reports them),
nor have its Mosaic layout choices `--shear` and `--pack`, `--counts` or
`--novalid`.

`sass_loop_mix(sass_of(library))` reads the static instruction mix of each
kernel's main loop from the built library (chip_smoke.py prints it), the
per-pair instruction count that the variants' times follow.
`cuda_ms` (CUDA events around one launch or several back to back) and
`dispatch_ms` (that mix's floor) are the timer and the floor that
chip_smoke.py and `utils/lab_ab` report with.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

WEIGHTS = (1.0, 3.0, 4.0, 2.0)

# Oracle results of this process, by (n1, n2): one check of a shape pays for
# the numpy oracle once, however many variants and rounds follow.
_ORACLE: dict = {}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def lab_inputs(n1: int, n2: int):
    """(tables, codes1, codes2) of the lab's query: random_sequences(n1, n2,
    seed=0), weights 1 3 4 2, minimum."""
    from psa_torch.core.alphabet import encode
    from psa_torch.core.tables import build_tables
    from psa_torch.utils.generator import random_sequences

    seq1, seq2 = random_sequences(n1, n2, seed=0)
    return build_tables(np.array(WEIGHTS), False), encode(seq1), encode(seq2)


def oracle(n1: int, n2: int):
    """`core/oracle.offset_stats_numpy` of the lab's (n1, n2) query,
    computed once per process."""
    if (n1, n2) not in _ORACLE:
        from psa_torch.core.oracle import offset_stats_numpy

        tables, c1, c2 = lab_inputs(n1, n2)
        _ORACLE[n1, n2] = offset_stats_numpy(c1, c2, tables)
    return _ORACLE[n1, n2]


# Pairs one thread handles in an iteration of a kernel's main loop:
# csrc/sweep_core.cuh's sweep_step, in sweep.cu and sweep_batched.cu (kFlush
# positions x kOffsetsPerThread offsets), and the lab's v2 and v3
# (csrc/sweep_mma.cu, csrc/sweep_mma_v3.cu: kChunk positions of one offset).
LOOP_PAIRS = {"sweep_kernel": 32 * 8, "sweep_batched_kernel": 32 * 8,
              "sweep_mma_kernel": 64, "sweep_v3_kernel": 64}
# Kernels whose main loop sits inside a persistent loop over work items:
# their main loop is the widest of the loops that hold no other loop.
INNERMOST = {"sweep_kernel", "sweep_batched_kernel"}


# An SM dispatches one warp instruction per clock from each of its four
# schedulers (H100 SXM: 132 SMs at 1.98 GHz): the time to dispatch a
# kernel's main-loop instructions (its SASS mix per pair) is a floor of that
# kernel as compiled, not of the function.
WARP_DISPATCH_PER_S = 132 * 4 * 1.98e9


def dispatch_ms(sass: dict, kernel: str, pairs: float):
    """ms to dispatch `kernel`'s main-loop instructions (`sass_loop_mix`)
    for `pairs` pairs at WARP_DISPATCH_PER_S; None where the loop's pairs
    are not known."""
    per_pair = sass.get(kernel, {}).get("per_pair")
    return pairs * per_pair / 32 / WARP_DISPATCH_PER_S * 1e3 if per_pair else None


def cuda_ms(torch, fn, runs: int, warm: int = 2, back_to_back: int = 1):
    """(median, p25, p75) device ms per call of fn() over `runs` runs, CUDA
    events around each run of `back_to_back` calls.  With one call the
    time includes the host's enqueue of the launch (the stream is idle when
    the first event passes); more calls keep the stream fed and leave it
    out."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(back_to_back):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / back_to_back)
    q1, _, q3 = statistics.quantiles(times, n=4)
    return statistics.median(times), q1, q3


def sass_of(library: str) -> str:
    """`cuobjdump -sass` of a built library (the CUDA toolkit's)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout


def _kernel_name(mangled: str) -> str:
    """`sweep_v3_kernel` or `sweep_batched_kernel<true>` from its mangled
    name (the last name of the nested name, with a bool template argument
    where it has one)."""
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j: j + int(mangled[i:j])], j + int(mangled[i:j])
    if mangled.startswith("ILb", i):
        name += "<true>" if mangled[i + 3] == "1" else "<false>"
    return name


def sass_loop_mix(sass: str) -> dict:
    """The static instruction mix of each kernel's main loop (its widest
    backward branch; for INNERMOST kernels the widest that holds no other)
    from `cuobjdump -sass` text: {kernel: {"instructions",
    "segments" (the loop's instructions between its barriers), "per_pair"
    (where LOOP_PAIRS knows the kernel), "mix" {opcode: count}}}."""
    out = {}
    for m in re.finditer(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        body = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", ins.strip()))
                for a, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                         m.group(2))]
        back = [(int(t, 16), a) for a, ins in body
                for t in re.findall(r"\bBRA\s+0x([0-9a-f]+)", ins) if int(t, 16) <= a]
        if not back:
            continue
        name = _kernel_name(m.group(1))
        if name.split("<")[0] in INNERMOST:
            back = [(h, t) for h, t in back
                    if not any(h <= h2 and t2 <= t and (h2, t2) != (h, t)
                               for h2, t2 in back)]
        head, tail = max(back, key=lambda ht: ht[1] - ht[0])
        loop = [ins.split()[0] for a, ins in body if head <= a <= tail]
        segments = [0]
        for op in loop:
            if op.startswith("BAR"):
                segments.append(0)
            else:
                segments[-1] += 1
        pairs = LOOP_PAIRS.get(name.split("<")[0])
        out[name] = {"instructions": len(loop), "segments": segments,
                     "per_pair": len(loop) / pairs if pairs else None,
                     "mix": dict(collections.Counter(loop).most_common())}
    return out


def _variant(name: str):
    """(sweep, offset_stats, plan_shapes, tile, chunk) of a variant."""
    from psa_torch.ops import sweep as sw

    if name == "v1":
        return sw.sweep, sw.offset_stats, sw.plan_shapes, sw.TILE_O, sw.L2_ALIGN
    if name == "v2":
        from psa_torch.ops import _sweep_v2 as v2
        return (v2.sweep_v2, v2.offset_stats_v2, v2.plan_shapes_v2, v2.TILE,
                v2.CHUNK)
    from psa_torch.ops import _sweep_v3 as v3
    return (v3.sweep_v3, v3.offset_stats_v3, v3.plan_shapes_v3, v3.TILE,
            v3.CHUNK)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m psa_torch.utils.kernel_lab",
                                 description="time a sweep variant on the card")
    ap.add_argument("--variant", default="v2", choices=["v1", "v2", "v3"])
    ap.add_argument("--n1", type=int, default=131072)
    ap.add_argument("--n2", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--check", action="store_true",
                    help="also hold the stats against the numpy oracle")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the plain versions (a CPU time)")
    args = ap.parse_args(argv)
    if args.iters < 1 or not 0 < args.n2 <= args.n1:
        log("[lab] error: need --iters >= 1 and 0 < n2 <= n1")
        return 2

    import torch

    from psa_torch.ops.sweep import upload_codes

    if args.device == "cuda" and not torch.cuda.is_available():
        log("[lab] error: no CUDA device (pass --device cpu for the plain "
            "versions)")
        return 2
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    sweep, stats, plan, tile, chunk = _variant(args.variant)
    try:
        _, _, l2p, l1k = plan(args.n1, args.n2)
    except ValueError as e:
        log(f"[lab] error: {e}")
        return 2
    tables, c1, c2 = lab_inputs(args.n1, args.n2)
    log(f"[lab] {args.variant} on {name}: {args.n1}x{args.n2}, tile {tile}, "
        f"chunk {chunk}")

    if args.check:
        counts, maxrank = stats(c1, c2, tables, dev)
        rc, rm = oracle(args.n1, args.n2)
        ok = np.array_equal(counts, rc) and np.array_equal(maxrank, rm)
        log(f"[lab] oracle check: {'OK' if ok else 'FAIL'}")
        if not ok:
            return 1

    code = torch.from_numpy(tables.code).to(dev)
    d1 = upload_codes(c1, l1k, dev)
    rolled = [upload_codes(np.roll(c2, i), l2p, dev) for i in range(args.iters)]
    sweep(d1, rolled[0], code)                  # builds the library, warms it
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for d2 in rolled:
            sweep(d1, d2, code)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / args.iters
    else:
        t0 = time.perf_counter()
        for d2 in rolled:
            sweep(d1, d2, code)
        ms = (time.perf_counter() - t0) * 1e3 / args.iters
    pairs = float(args.n1 - args.n2 + 1) * args.n2
    log(f"[lab] {args.variant} {args.n1}x{args.n2}: {ms:.4f} ms/sweep "
        f"({'CUDA events' if dev.type == 'cuda' else 'host clock, CPU'}), "
        f"{pairs / (ms * 1e-3):.3g} pair-evals/s")
    print(f"RESULT {args.variant} {tile} {chunk} {ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
