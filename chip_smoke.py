#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (psa_torch) on one GPU.

    python3 chip_smoke.py

Builds the sweep kernels from psa_torch/csrc and holds each against its
plain PyTorch version on the card (`sweep` also at the edges of its even
split, with the card's split beside `sweep_plan`'s; the lab's v2 and v3 at
the edges of their Seq2 segments, each with the card's split beside its
launch plan, `v2_launch_plan`'s or `v3_launch_plan`'s).  Drives the port's
paths, each with the kernels' launch counts zeroed just before it and read
just after:
- the single-query path (the engine and the `psa_torch.utils.cli` CLI) at
  the 100k x 10k north-star size;
- the exact batch path (`search_batch` and `psa_torch.utils.cli --batch`)
  on 1024 queries of 2048 x 512, per-row and with one shared Seq1, and on
  8192 per-row queries (8 microbatches in flight); and `search_batch` on
  the 109-case file, whose batched launches must be one per microbatch of
  each bucket of 1024-offset keys;
- the kernel lab (`psa_torch.utils.kernel_lab`): v1, v2 and v3 in turns
  with `--check` at 131072 x 8192, and its command line once at 100k x 10k;
- the serving tier (`psa_torch.utils.cli --serve`, `--listen`;
  psa_torch/utils/server.py) on the batch workload's queries as protocol
  lines, every reply held against the native engine's: 8192 queries with
  bad and blank lines through OS pipes, 8 TCP clients of 1024 queries at
  pipeline depths 2 and 4, closed loops of 8 clients x 252 (per-row and on
  one Seq1), the north-star query as one line, then the same code in this
  process (the stdin loop on an os.pipe, the TCP server on this thread)
  with the launches counted per wave, `--backend auto` in a closed loop,
  one traced 256-line chunk and a chunk's parse/dispatch/finish/format
  split;
- the sharded and multi-process paths (psa_torch/parallel): the north star
  through `search_sharded` on meshes of 1, 2, 4 and 8 shards of the one
  card, `search_sharded_2d` at (1,2), (2,2), (1,4) and (2,4), and
  `search_sharded_auto`, each with one `sweep` launch per shard; all-'A'
  ties at 200,000 x 2,048 taking the full-stats fallback; 600,000 x 250,000
  through `torch` and a 4-shard mesh against the native engine; the batch
  workload sharded over 4 (one batched launch per shard); two ranks on the
  card joined by Gloo (started directly, and through `psa_torch.utils.
  launcher -np 2` on the north-star file, the mixed --batch file, --batch
  --sharded and a bad input), and `psa-torch --sharded`, each output byte-
  equal to one process's;
- the host backends on the native host library (psa_torch/native, built
  with g++ at first use; the smoke fails unless it builds, self-tests and
  answers host selection): the north-star query through `torch`, `native`,
  `auto` and `hybrid` at device shares 0, 50 and 100, 1,000,000 x 2,048
  through `torch` against `native`, the CLI's host backends against
  `--backend numpy`, and the native engine's speed beside the card path's
  fixed cost, from which `auto_threshold` is derived.
Times the kernels (one launch per pair of CUDA events, and
KERNEL_BACK_TO_BACK launches per pair), their plain versions and the paths'
phases with CUDA events and synchronised host clocks, and prints one JSON
line per phase.
The second-to-last line lists each ported kernel; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import platform
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The north-star query (NORTHSTAR_r05.json): random_sequences(100000, 10000,
# seed=0), weights 1 3 4 2, minimum.
NORTH_STAR = dict(n1=100_000, n2=10_000, seed=0, weights=(1.0, 3.0, 4.0, 2.0),
                  is_max=False)
NORTH_STAR_WINNER = (84944, 10, 10, -21596.0)

# The batch workload of benchmarks/batch_bench.py: 1024 queries
# random_sequences(2048, 512, seed=s), s = 0..1023, weights 1 3 4 2, minimum;
# and its shared-Seq1 form (SHARED_DEDUP_r05.json): the 1024 Seq2 reads
# against the one Seq1 of seed 0.
BATCH = dict(b=1024, n1=2048, n2=512, weights=(1.0, 3.0, 4.0, 2.0), is_max=False)

# The north-star query through every backend setting of the single-query
# engine: (backend, device_share).
NS_BACKENDS = [("torch", None), ("native", None), ("auto", None),
               ("hybrid", 0.0), ("hybrid", 50.0), ("hybrid", 100.0)]
# Long Seq1 end to end (NORTHSTAR_r05's big_seq1 shape):
# random_sequences(1_000_000, 2048, seed=1), weights 1 3 4 2, minimum.
LONG_SEQ1 = dict(n1=1_000_000, n2=2048, seed=1)
# Shapes at which the card path's fixed cost per query and the native
# engine's time are measured side by side for `auto_threshold`.
SMALL_SHAPES = [(1000, 100), (5000, 500), (20_000, 2000), (50_000, 5000)]

# The kernel lab's query (benchmarks/kernel_lab.py's defaults, the bench.py
# shape): random_sequences(131072, 8192, seed=0), weights 1 3 4 2, minimum;
# each variant timed over 16 launches, in turns over 3 rounds.
LAB = dict(n1=131_072, n2=8192, iters=16, rounds=3)

# Published H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM
# 3.35 TB/s; 67 TFLOP/s fp32 = 132 SMs x 128 fp32 lanes x 2 x 1.98 GHz.  An
# SM has half as many INT32 lanes (64), so the INT32 rate is a quarter of
# the fp32 FLOP rate; shared memory serves 32 lanes per SM per clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
SMEM_LOADS_PER_S = 132 * 32 * 1.98e9
# The least work per (offset, position) pair on the table route (csrc/sweep.cu
# and csrc/sweep_batched.cu): one shared-memory table read and two integer
# ops, as the batched pair loop does it (one address add, and half an IADD3
# and half a VIMNMX3: it accumulates and maxes two positions per
# instruction).  At these rates the table reads bound the route.
INT_OPS_PER_PAIR = 2
# The tensor-core route of the lab's sweeps (csrc/sweep_mma.cu and
# csrc/sweep_mma_v3.cu): per pair, a 32-deep int8 product (64 ops) at the
# dense int8 peak, one band byte written to and read from shared memory
# (128 bytes per SM per clock), and the decode's INT32 ops
# (DECODE_OPS_PER_WORD of ops/_sweep_v2.py and ops/_sweep_v3.py, per 4
# pairs).
INT8_TC_OPS_PER_S = 1979e12
TC_OPS_PER_PAIR = 64
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
# A kernel is timed two ways (see kernel_times): one launch per pair of
# CUDA events, the `ms` of the kernels line, and this many launches per
# pair, `ms_back_to_back`; the plain versions, which take 10-1000 ms, are
# timed one call per pair.
KERNEL_BACK_TO_BACK = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def sweep_bound(pairs: float, in_bytes: int, out_bytes: int):
    """(bound_ms, bound_by) of a sweep: the bytes of each input read once
    and of the output written once over HBM, against this run's real
    (offset, position) pairs over the INT32 and shared-memory rates."""
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(pairs * INT_OPS_PER_PAIR / INT32_OPS_PER_S,
                 pairs / SMEM_LOADS_PER_S) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def single_bound(noff: int, n2: int, l1k: int, l2p: int, noff_pad: int):
    """`sweep_bound` of one query's sweep: its real pairs, its stats5 (5
    rows) written once."""
    return sweep_bound(float(noff) * n2, l1k + l2p + 32 * 32, 5 * 4 * noff_pad)


def batched_bound(noffs, n2s, l1_bytes: int, c2b_bytes: int, noff_pad: int):
    """`sweep_bound` of a batched sweep: every query's real pairs, its
    stats5 (5 rows) written once."""
    pairs = float(np.dot(np.asarray(noffs, np.float64), np.asarray(n2s, np.float64)))
    return sweep_bound(pairs, l1_bytes + c2b_bytes + 32 * 32,
                       5 * 4 * noff_pad * len(noffs))


def lab_bound(mod, noff: int, n2: int, l1k: int, l2p: int, noff_pad: int):
    """(bound_ms, bound_by, terms) of a lab sweep on its own route, over
    this run's real pairs: the largest of the HBM bytes (codes in, 8 rows
    out), the tensor-core ops, the band's shared-memory bytes and the
    decode's INT32 ops."""
    pairs = float(noff) * n2
    terms = {"hbm_ms": (l1k + l2p + 32 * 32 + 8 * 4 * noff_pad) / HBM_BYTES_PER_S * 1e3,
             "tensor_core_ms": pairs * TC_OPS_PER_PAIR / INT8_TC_OPS_PER_S * 1e3,
             "smem_band_ms": pairs * 2 / SMEM_BYTES_PER_S * 1e3,
             "decode_ms": pairs * mod.DECODE_OPS_PER_WORD / 4 / INT32_OPS_PER_S * 1e3}
    top = max(terms, key=terms.get)
    return (terms[top], "bytes" if top in ("hbm_ms", "smem_band_ms") else "operations",
            terms)


def kernel_times(torch, fn, runs: int):
    """`cuda_ms` of a kernel call at one launch per pair of events and at
    KERNEL_BACK_TO_BACK launches per pair: ((median, p25, p75), (...))."""
    from psa_torch.utils.kernel_lab import cuda_ms

    return (cuda_ms(torch, fn, runs),
            cuda_ms(torch, fn, runs, back_to_back=KERNEL_BACK_TO_BACK))


def random_codes(rng, n: int, hyphen_p: float = 0.0, other_p: float = 0.0):
    codes = rng.integers(0, 26, n).astype(np.int32)
    codes[rng.random(n) < hyphen_p] = 26
    codes[rng.random(n) < other_p] = 27
    return codes


def cpu_info() -> dict:
    """The host CPU's model and cores, as the native engine sees them (a
    virtual machine may report its model name as "unknown": the vendor,
    family, model number and vector extensions then say what it is)."""
    fields = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for ln in f:
            key, _, val = ln.partition(":")
            fields.setdefault(key.strip(), val.strip())
    flags = fields.get("flags", "").split()
    return {"cpu_model": fields.get("model name", platform.processor()),
            "cpu_vendor": fields.get("vendor_id"),
            "cpu_family_model": [fields.get("cpu family"), fields.get("model")],
            "cpu_vector": [x for x in ("avx2", "avx512f", "avx512bw") if x in flags],
            "cpu_count": os.cpu_count(), "cpus_usable": len(os.sched_getaffinity(0))}


def openmp_runtimes() -> list:
    """The OpenMP runtimes mapped into this process (torch ships its own
    libgomp; the native library links the system's)."""
    paths = set()
    with open("/proc/self/maps") as f:
        for ln in f:
            parts = ln.split()
            if len(parts) >= 6 and any(k in parts[-1] for k in ("gomp", "libomp", "iomp")):
                paths.add(parts[-1])
    return sorted(paths)


def host_engine_phase(torch, native):
    """Build (or find) and self-test the native host library; the phase's
    JSON object."""
    path = Path(native.lib_path())
    prebuilt = path.is_file()
    t0 = time.perf_counter()
    try:
        native.get_lib()
        error = None
    except (RuntimeError, OSError) as e:
        error = str(e)[-600:]
    ok = native.available()
    return {"phase": "host_engine", "engine": native.host_engine(),
            "library": str(path.relative_to(ROOT)) if path.is_relative_to(ROOT) else str(path),
            "built_now": not prebuilt, "build_s": time.perf_counter() - t0,
            "self_test": "passed" if ok else "failed", "error": error,
            "omp_threads": native.omp_max_threads() if ok else None,
            "torch_threads": torch.get_num_threads(),
            "openmp_runtimes": openmp_runtimes(), **cpu_info()}


def wall_ms(fn, runs: int, warm: int = 1):
    """(median, min, max) host ms of fn() over `runs` warm runs."""
    for _ in range(warm):
        fn()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), min(walls), max(walls)


def zero_launches(sw, v2, v3) -> None:
    sw.launches = sw.launches_batched = sw.launches_batched_shared = 0
    v2.launches_v2 = v3.launches_v3 = 0


def read_launches(sw, v2, v3) -> dict:
    return {"sweep": sw.launches, "sweep_batched": sw.launches_batched,
            "sweep_batched_shared": sw.launches_batched_shared,
            "sweep_v2": v2.launches_v2, "sweep_v3": v3.launches_v3}


def padded_batch(rng, sw, b: int, n1: int, n2: int, hyphen_p: float = 0.0,
                 other_p: float = 0.0, ragged: bool = False):
    """(c1b, c2b, noffs, n2s) of b random queries of the bucket of (n1, n2),
    padded as `search_batch` pads it (`plan_bucket`); ragged rows are up to
    a third shorter."""
    l2p = sw.plan_shapes(n1, n2)[2]
    noffs, n2s = np.zeros(b, np.int64), np.zeros(b, np.int64)
    for q in range(b):
        m1 = n1 - (int(rng.integers(0, n1 // 3)) if ragged else 0)
        n2s[q] = min(m1, n2 - (int(rng.integers(0, n2 // 3)) if ragged else 0))
        noffs[q] = m1 - n2s[q] + 1
    _, l1k = sw.plan_bucket(noffs, l2p)
    c1b = np.full((b, l1k), 28, np.uint8)
    c2b = np.full((b, l2p), 28, np.uint8)
    for q in range(b):
        m1 = int(noffs[q] + n2s[q] - 1)
        c1b[q, :m1] = random_codes(rng, m1, hyphen_p, other_p)
        c2b[q, :n2s[q]] = random_codes(rng, int(n2s[q]), hyphen_p, other_p)
    return c1b, c2b, noffs, n2s


def pad_offsets(torch, c1b, noff_pad: int, l2p: int):
    """c1b (B, l1k) on the card, its Seq1 rows padded with PAD_CODE to
    noff_pad + l2p (noff_pad at least the rows' own)."""
    wide = torch.full((c1b.shape[0], noff_pad + l2p), 28, dtype=torch.uint8,
                      device=c1b.device)
    wide[:, :c1b.shape[1]] = c1b
    return wide


def batched_kernel_checks(torch, sw, code, dev):
    """Both batched kernels against their plain versions on the card, all 5
    rows of stats5 (tolerance 0: every statistic is an exact integer), at
    the batch workload's shape and at the work list's edges; the shared
    kernel also against the per-row one on broadcast rows, and both
    refusing a misaligned row.  Returns ({kernel: max_abs_diff}, the B =
    1024 of 2048 x 512 inputs) or raises."""
    rng = np.random.default_rng(99)
    worst = {"sweep_batched": 0, "sweep_batched_shared": 0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(kernel, case, got, want, shape):
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max().item())
        worst[kernel] = max(worst[kernel], diff)
        emit({"phase": "batched_kernel_vs_plain", "kernel": kernel, "case": case,
              "shape": shape, "max_abs_diff": diff, "tolerance": 0,
              "rows4_sum": int(got[:, :4].sum().item())})
        if diff != 0:
            raise AssertionError(f"{kernel} disagrees with its reference at {case}")

    # one query's worth of warp slots at Seq2 rows of 1120 codes: a bucket
    # of 4-tile queries just past it sweeps two segments per item
    slots = sw.batched_plan(1120, sw.TILE_O, 1, False)["blocks_per_sm"] * 4 * sms
    big = None
    for case, b, n1, n2, hp, op, ragged, shared in (
            ("batch_2048x512", BATCH["b"], BATCH["n1"], BATCH["n2"], 0.0, 0.0, False, True),
            ("b8_20000x2000", 8, 20_000, 2000, 0.0, 0.0, False, False),
            ("ragged_lenient", 48, 5000, 700, 0.05, 0.05, True, False),
            ("b16_100000x2048", 16, 100_000, 2048, 0.0, 0.0, False, True),
            ("noff_1", 5, 300, 300, 0.0, 0.0, False, True),
            ("noff_multiple_of_tile", 7, 967, 200, 0.0, 0.0, False, True),
            ("b_1", 1, 3000, 500, 0.0, 0.0, False, True),
            ("b_not_multiple_of_slots", 1111, 1000, 300, 0.0, 0.0, False, True),
            ("seq2_segments", slots // 4 + 5, 2123, 1100, 0.0, 0.0, False, True),
            ("seq2_split", 2, 5000, 4000, 0.0, 0.0, False, True)):
        c1b, c2b, _, _ = padded_batch(rng, sw, b, n1, n2, hp, op, ragged)
        d1 = torch.from_numpy(c1b).to(dev)
        d2 = torch.from_numpy(c2b).to(dev)
        shape = list(c1b.shape) + [c2b.shape[1]]
        plans = {k: sw.batched_plan(c2b.shape[1], c1b.shape[1] - c2b.shape[1], b, k)
                 for k in (False, True)}
        emit({"phase": "batched_plan", "case": case, "shape": shape,
              "per_row": plans[False], "shared": plans[True]})
        p = plans[False]
        if ((case == "seq2_segments" and not (p["parts"] == 1 and p["segs_per_part"] > 1))
                or (case == "seq2_split" and p["parts"] == 1)):
            raise AssertionError(f"{case} did not take the work list it is for")
        check("sweep_batched", case, sw.sweep_batched(d1, d2, code),
              sw.sweep_batched_plain(d1, d2, code), shape)
        if big is None:
            big = (d1, d2)
        if shared:
            row = d1[0].contiguous()
            got = sw.sweep_batched_shared(row, d2, code)
            check("sweep_batched_shared", case, got,
                  sw.sweep_batched_shared_plain(row, d2, code), shape)
            check("sweep_batched_shared", f"{case}_vs_sweep_batched_broadcast", got,
                  sw.sweep_batched(row[None].expand(b, -1).contiguous(), d2, code),
                  shape)
    flat = torch.full((1 + 2 * 320,), 28, dtype=torch.uint8, device=dev)
    for kernel, call in (
            ("sweep_batched", lambda: sw.sweep_batched(flat[1:].view(2, 320),
                                                       big[1][:2, :64].contiguous(), code)),
            ("sweep_batched_shared", lambda: sw.sweep_batched_shared(
                flat[1:321], big[1][:2, :64].contiguous(), code))):
        try:
            call()
        except ValueError as e:
            emit({"phase": "batched_misaligned", "kernel": kernel, "raised": str(e)})
        else:
            raise AssertionError(f"{kernel} took a misaligned Seq1 row")
    return worst, big


# `sweep` against its plain version: the five shapes of earlier runs,
# 1M x 2048, and the even split's edges (ranges of several whole tiles at
# l2p = 32, fewer units than workers, noff = 1, a whole tile whose last step
# is ragged, one tile split over ~90 workers, and Seq2 past 65,536 positions
# with 512 offsets); (n1, n2, hyphen_p, other_p, PAD_CODE inside the
# sequences)
SWEEP_CASES = [("ragged", 1000, 137, 0.05, 0.0, False),
               ("bench", 131072, 8192, 0.0, 0.0, False),
               ("north_star", 100_000, 10_000, 0.0, 0.0, False),
               ("long_seq1", 400_000, 2048, 0.0, 0.0, False),
               ("lenient", 50_000, 3000, 0.05, 0.05, False),
               ("seq1_1M", 1_000_000, 2048, 0.0, 0.0, False),
               ("ranges_of_whole_tiles", 2_000_000, 20, 0.05, 0.05, True),
               ("noff_1", 300, 300, 0.05, 0.05, True),
               ("whole_tiles_ragged_step", 2_000_000, 1500, 0.05, 0.05, True),
               ("tile_over_90_workers", 40_000, 30_000, 0.05, 0.05, True),
               ("seq2_past_65536", 70_511, 70_000, 0.05, 0.05, True)]


def split_plan(sw, noff_pad: int, l2p: int):
    """The card's split of a `sweep` launch, checked against `sweep_plan`
    with the card's workers (units, most units per worker, shared tiles)."""
    card = sw.sweep_launch_plan(l2p, noff_pad)
    model = sw.sweep_plan(noff_pad, l2p, card["workers"])
    keys = ("units", "per_worker", "split_tiles")
    if any(card[k] != model[k] for k in keys):
        raise AssertionError(f"the card's split {card} is not sweep_plan's "
                             f"{ {k: model[k] for k in keys} }")
    return card


def sweep_checks(torch, sw, code, dev):
    """`sweep` against its plain version on the card at SWEEP_CASES, all 5
    rows of stats5 (tolerance 0: every statistic is an exact integer), each
    case with its split; and a misaligned operand refused.  Returns the
    largest difference or raises."""
    rng = np.random.default_rng(2024)
    max_abs = 0
    for name, n1, n2, hp, op, pad in SWEEP_CASES:
        c1 = random_codes(rng, n1, hp, op)
        c2 = random_codes(rng, n2, hp, op)
        if pad:
            c1[::41] = 28
            c2[::43] = 28
        noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
        plan = split_plan(sw, noff_pad, l2p)
        d1 = sw.upload_codes(c1, l1k, dev)
        d2 = sw.upload_codes(c2, l2p, dev)
        got = sw.sweep(d1, d2, code)
        torch.cuda.synchronize()
        want = sw.sweep_plain(d1, d2, code)
        diff = int((got.long() - want.long()).abs().max().item())
        max_abs = max(max_abs, diff)
        emit({"phase": "kernel_vs_plain", "case": name, "n1": n1, "n2": n2,
              "noff_pad": noff_pad, "l2p": l2p, "max_abs_diff": diff,
              "tolerance": 0, "rows": list(got.shape), "plan": plan,
              "rows4_sum": int(got[:4, :noff].sum().item())})
        if diff != 0 or tuple(got.shape) != (5, noff_pad):
            raise AssertionError(f"sweep disagrees with its plain version at {name}")
    flat = torch.full((1 + 256 + 64,), 28, dtype=torch.uint8, device=dev)
    try:
        sw.sweep(flat[1:], flat[1:65].clone(), code)
    except ValueError as e:
        emit({"phase": "sweep_misaligned", "raised": str(e)})
    else:
        raise AssertionError("sweep took a misaligned Seq1")
    return max_abs


def lab_edges(v3):
    """The edges of the lab kernels' Seq2 splits (csrc/sweep_mma.cuh):
    (case, n1, n2, letter pair or None for random codes, code at that pair
    or None, hyphen and OTHER_CODE shares).  l2p = MAX_N2 over 128 tiles
    makes v3's segments of LANE_CHUNKS chunks, so every byte lane fills:
    every pair in class 2 (both slot bits), then every pair at the largest
    code the contract allows (126, also v2's DPX max over several
    segments); one tile of one chunk; a chunk count v3's segments do not
    divide; one segment per tile (both); 157 chunks, a prime, over v2's
    segments; and a lenient query over v2's segments, whose row 3 goes
    through the atomics (v2 only)."""
    n1_full = v3.MAX_N2 + 128 * 256 - 1
    return [("max_n2_one_class", n1_full, v3.MAX_N2, (0, 2), None, 0.0, 0.0),
            ("max_n2_max_code", n1_full, v3.MAX_N2, (0, 2), 126, 0.0, 0.0),
            ("one_tile_one_chunk", 300, 64, None, None, 0.0, 0.0),
            ("segments_uneven", 1_000_000, 2000, None, None, 0.0, 0.0),
            ("one_segment_per_tile", 1_000_000, 500, None, None, 0.0, 0.0),
            ("v2_segments_uneven", 100_000, 10_000, None, None, 0.0, 0.0),
            ("v2_lenient_segments", 200_000, 3000, None, None, 0.05, 0.05)]


# What each edge must be in a kernel's split on the card; a kernel that runs
# an edge only as the control has no entry.
LAB_EDGE_HOLDS = {
    ("sweep_v3", "max_n2_one_class"): lambda p, v3: p["most_chunks"] == v3.LANE_CHUNKS,
    ("sweep_v3", "max_n2_max_code"): lambda p, v3: p["most_chunks"] == v3.LANE_CHUNKS,
    ("sweep_v2", "max_n2_max_code"): lambda p, v3: p["segs"] > 1,
    ("sweep_v2", "one_tile_one_chunk"): lambda p, v3: (p["tiles"], p["chunks"], p["segs"]) == (1, 1, 1),
    ("sweep_v3", "one_tile_one_chunk"): lambda p, v3: (p["tiles"], p["chunks"], p["segs"]) == (1, 1, 1),
    ("sweep_v3", "segments_uneven"): lambda p, v3: p["chunks"] % p["segs"] != 0,
    ("sweep_v2", "one_segment_per_tile"): lambda p, v3: p["segs"] == 1 < p["chunks"],
    ("sweep_v3", "one_segment_per_tile"): lambda p, v3: p["segs"] == 1 < p["chunks"],
    ("sweep_v2", "v2_segments_uneven"): lambda p, v3: 1 < p["segs"] and p["chunks"] % p["segs"] != 0,
    ("sweep_v2", "v2_lenient_segments"): lambda p, v3: p["segs"] > 1,
}


def lab_plan(v2, v3, kernel: str, noff_pad: int, l2p: int):
    """A lab kernel's split on the card (`v2_card_plan`, `v3_card_plan`),
    checked against its launch plan (`v2_launch_plan`, `v3_launch_plan`)
    with the card's slots."""
    card_plan, launch_plan = {"sweep_v2": (v2.v2_card_plan, v2.v2_launch_plan),
                              "sweep_v3": (v3.v3_card_plan, v3.v3_launch_plan)}[kernel]
    card = card_plan(noff_pad, l2p)
    model = launch_plan(noff_pad, l2p, card["slots"])
    keys = ("tiles", "chunks", "segs", "blocks", "most_chunks")
    if any(card[k] != model[k] for k in keys):
        raise AssertionError(f"the card's {kernel} split {card} is not its launch plan's "
                             f"{ {k: model[k] for k in keys} }")
    return card


def lab_kernel_checks(torch, sw, v2, v3, code, dev):
    """The lab's tensor-core sweeps against their plain versions on the
    card, all 8 rows (tolerance 0: every statistic is an exact integer); v3
    on clean inputs only, each case with each kernel's split; then the
    splits' edges (`lab_edges`), each checked against LAB_EDGE_HOLDS.
    Returns {kernel: max_abs_diff} or raises."""
    rng = np.random.default_rng(303)
    worst = {"sweep_v2": 0, "sweep_v3": 0}
    cases = [(case, n1, n2, None, None, hp, op)
             for case, n1, n2, hp, op in (("ragged", 1000, 137, 0.05, 0.0),
                                          ("bench", LAB["n1"], LAB["n2"], 0.0, 0.0),
                                          ("north_star", 100_000, 10_000, 0.0, 0.0),
                                          ("long_seq1", 400_000, 2048, 0.0, 0.0),
                                          ("lenient", 50_000, 3000, 0.05, 0.05))]
    cases += lab_edges(v3)
    table = code.cpu().numpy()
    for case, n1, n2, pair, top, hp, op in cases:
        noff, noff_pad, l2p, l1k = v2.plan_shapes_v2(n1, n2)
        case_code = code
        if pair is None:
            c1, c2 = random_codes(rng, n1, hp, op), random_codes(rng, n2, hp, op)
        else:
            c1, c2 = np.full(n1, pair[0]), np.full(n2, pair[1])
            if top is not None:
                t = table.copy()
                t[pair] = top
                case_code = torch.from_numpy(t).to(dev)
        d1 = sw.upload_codes(c1, l1k, dev)
        d2 = sw.upload_codes(c2, l2p, dev)
        kernels = [("sweep_v2", v2.sweep_v2, v2.sweep_v2_plain)]
        if op == 0.0:
            kernels.append(("sweep_v3", v3.sweep_v3, v3.sweep_v3_plain))
        for kernel, fn, plain in kernels:
            plan = lab_plan(v2, v3, kernel, noff_pad, l2p)
            if not LAB_EDGE_HOLDS.get((kernel, case), lambda p, v3: True)(plan, v3):
                raise AssertionError(f"{kernel}'s split at {case} is not the edge it "
                                     f"tests: {plan}")
            got = fn(d1, d2, case_code)
            torch.cuda.synchronize()
            diff = int((got.long() - plain(d1, d2, case_code).long()).abs().max().item())
            worst[kernel] = max(worst[kernel], diff)
            emit({"phase": "lab_kernel_vs_plain", "kernel": kernel, "case": case,
                  "n1": n1, "n2": n2, "noff_pad": noff_pad, "l2p": l2p,
                  "max_abs_diff": diff, "tolerance": 0,
                  "rows4_sum": int(got[:4, :noff].sum().item()),
                  "row3_sum": int(got[3, :noff].sum().item()),
                  "max_code": int(got[4, :noff].max().item()), "plan": plan})
            if diff != 0:
                raise AssertionError(f"{kernel} disagrees with its plain version "
                                     f"at {case}")
    return worst


def lab_cli_beside_oracle(kernel_lab):
    """Run `python -m psa_torch.utils.kernel_lab --variant v3` at 100k x 10k
    with --check as a process while this process computes the oracle of the
    lab's query (both on the host).  Returns the phase's JSON object; the
    process is stopped whatever happens."""
    argv = ["--variant", "v3", "--n1", "100000", "--n2", "10000", "--check"]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "psa_torch.utils.kernel_lab",
                             *argv], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        kernel_lab.oracle(LAB["n1"], LAB["n2"])
        oracle_s = time.perf_counter() - t0
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = out.strip().splitlines()
    return {"phase": "lab_cli", "argv": argv, "rc": proc.returncode,
            "result": lines[-1] if lines else None,
            "seconds": time.perf_counter() - t0, "oracle_s": oracle_s,
            "stderr_tail": err[-400:]}


def lab_rounds(kernel_lab):
    """`kernel_lab.main` with --check for v1, v2 and v3 in turns over
    LAB["rounds"] rounds; returns {variant: [ms per round]} or raises."""
    ms = {v: [] for v in ("v1", "v2", "v3")}
    for r in range(LAB["rounds"]):
        for v in ms:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = kernel_lab.main(["--variant", v, "--n1", str(LAB["n1"]),
                                      "--n2", str(LAB["n2"]),
                                      "--iters", str(LAB["iters"]), "--check"])
            lines = buf.getvalue().strip().splitlines()
            fields = lines[-1].split() if lines else []
            emit({"phase": "lab_round", "round": r, "variant": v, "rc": rc,
                  "result": lines[-1] if lines else None})
            if rc != 0 or fields[:2] != ["RESULT", v]:
                raise AssertionError(f"kernel_lab --variant {v} --check failed "
                                     f"(rc {rc})")
            ms[v].append(float(fields[-1]))
    return ms


def batch_queries(Query, random_sequences, shared: bool, b: int = BATCH["b"]):
    """The batch workload (see BATCH), seeds 0..b-1."""
    w = np.array(BATCH["weights"])
    qs = []
    for s in range(b):
        s1, s2 = random_sequences(BATCH["n1"], BATCH["n2"], seed=s)
        qs.append(Query(w, qs[0].seq1 if shared and qs else s1, s2,
                        BATCH["is_max"]))
    return qs


def write_batch_cases(path: Path, generator, random_sequences) -> int:
    """A `psa-torch-gen` file of mixed sizes: three generated buckets (both
    modes, one with hyphens), one shared-Seq1 bucket and one lenient
    no-mutation case.  Returns the number of cases."""
    text, n = [], 0
    for i, args in enumerate([["2048", "512", "--cases", "64", "--seed", "5000"],
                              ["5000", "1000", "--cases", "8", "--mode", "maximum",
                               "--hyphen-rate", "0.05", "--weights", "2,1,5,0.5"],
                              ["700", "120", "--cases", "16", "--seed", "77"]]):
        part = path.with_name(f"part{i}.txt")
        if generator.main([*args, "-o", str(part)]) != 0:
            raise AssertionError(f"psa-torch-gen {args} failed")
        text.append(part.read_text())
        n += int(args[args.index("--cases") + 1])
    ref = random_sequences(3000, 10, seed=1)[0]
    for s in range(20):
        text.append(f"1 3 4 2\n{ref}\n{random_sequences(300, 300, seed=100 + s)[1]}"
                    "\nminimum\n")
    text.append("1 3 4 2\n" + "?" * 600 + "\n" + "!" * 50 + "\nmaximum\n")
    path.write_text("".join(text))
    return n + 21


def batch_split(torch, batch, alphabet, queries, dtabs, shared: bool, runs: int):
    """The batch path for one 1024-query bucket, phase by phase with a
    synchronise after each: host prep (validation, encode), upload, device
    (kernel, epilogue, pack), fetch, host selection.  Median ms per phase
    over `runs` warm runs; returns (split, results of the last run, queries
    of the last run whose f32 band held more than k offsets, the near > k
    fallbacks)."""
    split = {k: [] for k in ("host_prep", "upload", "device", "fetch",
                             "host_select", "total")}
    dev = dtabs.code.device
    for it in range(runs + 2):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        ok = (alphabet.validate_batch([q.seq1 for q in queries])
              & alphabet.validate_batch([q.seq2 for q in queries]))
        assert ok.all()
        _, _, l2p, _ = batch.plan_shapes(len(queries[0].seq1), len(queries[0].seq2))
        noffs = np.array([len(q.seq1) - len(q.seq2) + 1 for q in queries], np.int32)
        _, l1k = batch.plan_bucket(noffs, l2p)
        c1b = alphabet.encode_batch_padded([q.seq1 for q in queries], l1k)
        c2b = alphabet.encode_batch_padded([q.seq2 for q in queries], l2p)
        n2s = np.array([len(q.seq2) for q in queries], np.int32)
        t.append(time.perf_counter())
        _, c1d = batch.upload_rows(c1b[0] if shared else c1b, dev)
        _, c2d = batch.upload_rows(c2b, dev)
        _, nd = batch.upload_rows(noffs, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        packed = batch.run_exact_batch(c1d, c2d, nd, dtabs, shared_s1=shared)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        buf = batch.start_fetch(packed).wait()
        t.append(time.perf_counter())
        topi, stats_k, near, best = batch.unpack_epilogue_outputs(buf, batch.TOPK)
        res = batch._host_select(c1b, c2b, noffs, n2s, dtabs, topi,
                                 np.swapaxes(stats_k, 1, 2), near, best, batch.TOPK)
        t.append(time.perf_counter())
        if it >= 2:
            for name, a, b in zip(list(split)[:5], t, t[1:]):
                split[name].append((b - a) * 1e3)
            split["total"].append((t[-1] - t[0]) * 1e3)
    return ({k: statistics.median(v) for k, v in split.items()}, res,
            int((near > batch.TOPK).sum()))


def traced_busy(torch, fn):
    """(host ms, device busy ms, top device events) of one traced call:
    the device-side events only (kernels, copies, memsets), since the
    operator entries on the host side repeat their kernels' time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev_us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and ev.self_device_time_total > 0}
    return (host_ms, sum(dev_us.values()) / 1e3,
            sorted(dev_us.items(), key=lambda kv: -kv[1])[:6])

# The serving tier's waves (the batch workload's queries as protocol lines):
# 8192 per-row queries through the stdin loop at --serve-batch 1024, the same
# 8192 from 8 TCP clients of 1024 each at --serve-batch 256 (pipeline depths
# 2 and 4), and closed loops of 8 clients x 252 (SERVE_r05's 2,016), per-row
# and on the one Seq1 of seed 0.
SERVE = dict(clients=8, pipe_batch=1024, tcp_batch=256, closed_per_client=252,
             depths=(2, 4), bad_lines=16)
SERVE_CMD = [sys.executable, "-m", "psa_torch.utils.cli", "--serve"]


def serve_line(q) -> str:
    """One protocol line of a Query (the 7 input-file tokens)."""
    w = " ".join("%g" % x for x in q.weights)
    return f"{w} {q.seq1} {q.seq2} {'maximum' if q.is_max else 'minimum'}"


def reply_line(q, r) -> str:
    """The reply the server owes to a query with result r (None: none)."""
    if r is None:
        return "-1 %g %s" % (float("-inf") if q.is_max else float("inf"), q.seq2)
    return "%d %g %s" % (r.offset, r.score, r.mutant(q.seq2))


def bad_serve_lines(queries, n: int):
    """n malformed lines, four kinds in turn: too few tokens, nan weights, an
    out-of-alphabet Seq2, a Seq2 longer than its Seq1."""
    out = []
    for i in range(n):
        q = queries[i]
        out.append(["1 3 4 2 ABC minimum", f"nan 3 4 2 {q.seq1} {q.seq2} minimum",
                    f"1 3 4 2 {q.seq1} {q.seq2[:-1]}j minimum",
                    f"1 3 4 2 {q.seq2} {q.seq1} minimum"][i % 4])
    return out


class ServeProc:
    """`python -m psa_torch.utils.cli --serve ...` as a subprocess, its stderr
    drained by a thread (the server's per-chunk log lines are kept)."""

    def __init__(self, args, env_extra=None, stdin=None, stdout=None):
        env = dict(os.environ, **(env_extra or {}))
        self.proc = subprocess.Popen([*SERVE_CMD, *args], cwd=ROOT, env=env,
                                     stdin=stdin, stdout=stdout,
                                     stderr=subprocess.PIPE, text=True)
        self.err: list = []
        self.port = None
        first = self.proc.stderr.readline() if "--listen" in args else ""
        if "--listen" in args:
            if "listening on" not in first:
                self.proc.kill()
                raise AssertionError(f"serve --listen did not start: {first!r}")
            self.port = int(first.rsplit(":", 1)[1])
        self._t = threading.Thread(target=lambda: self.err.extend(self.proc.stderr),
                                   daemon=True)
        self._t.start()

    def chunk_log(self):
        """(queries, ms) of each chunk the server logged."""
        out = []
        for ln in self.err:
            parts = ln.split()
            if ln.startswith("[serve]") and "queries" in parts and parts[-1] == "total)":
                out.append((int(parts[1]), float(parts[parts.index("ms") - 1])))
        return out

    def stop(self) -> int:
        import signal

        if self.port is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(timeout=30)
        self._t.join(timeout=10)
        return rc


def tcp_clients(addr, per_client, closed: bool):
    """Each list of per_client from its own connection, all at once: either
    every line sent at once and the replies read until the server closes
    (closed=False), or one line at a time, each sent after the previous
    reply (closed=True).  Returns (replies per client, closed-loop latencies
    in ms, seconds from the first connect to the last reply)."""
    import socket

    replies = [None] * len(per_client)
    lat: list = []
    errors: list = []

    def one(c):
        try:
            with socket.create_connection(addr, timeout=300) as sock:
                if closed:
                    got = []
                    f = sock.makefile("rb")
                    for ln in per_client[c]:
                        t0 = time.perf_counter()
                        sock.sendall((ln + "\n").encode())
                        got.append(f.readline().decode().rstrip("\n"))
                        lat.append((time.perf_counter() - t0) * 1e3)
                    sock.shutdown(socket.SHUT_WR)
                    rest = f.read().decode().splitlines()
                    replies[c] = got + rest
                    return
                buf = []
                reader = threading.Thread(target=lambda: buf.extend(iter(
                    lambda: sock.recv(1 << 16), b"")))
                reader.start()
                sock.sendall(("\n".join(per_client[c]) + "\n").encode())
                sock.shutdown(socket.SHUT_WR)
                reader.join(timeout=300)
                replies[c] = b"".join(buf).decode().splitlines()
        except OSError as e:
            errors.append(f"client {c}: {e}")

    threads = [threading.Thread(target=one, args=(c,)) for c in range(len(per_client))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    if errors:
        raise AssertionError("; ".join(errors))
    return replies, lat, secs


def percentiles(ms):
    a = np.asarray(ms)
    return {"p50": float(np.percentile(a, 50)), "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max()), "n": int(a.size)}


def mismatches(replies, want) -> int:
    """Reply lines that differ from the expected ones (a missing line counts)."""
    bad = sum(abs(len(r) - len(w)) for r, w in zip(replies, want))
    return bad + sum(a != b for r, w in zip(replies, want) for a, b in zip(r, w))


def split(lines, n: int, each: int):
    return [lines[c * each:(c + 1) * each] for c in range(n)]


def serve_in_process(srv, per_client, closed: bool):
    """The TCP server's event loop on this (the main) thread, the clients on
    a thread that stops the server once every client is answered."""
    out: list = []

    def drive():
        try:
            while srv.bound_addr is None:
                time.sleep(0.005)
            out.append(tcp_clients(srv.bound_addr, per_client, closed))
        except AssertionError as e:
            out.append(e)
        finally:
            srv.request_stop()

    t = threading.Thread(target=drive)
    t.start()
    rc = srv.run()
    t.join(timeout=600)
    if rc != 0 or not out or isinstance(out[0], AssertionError):
        raise AssertionError(f"in-process server rc {rc}: {out[:1]}")
    return out[0]


def event_wait_gil(torch, dev, n: int = 4096, reps: int = 40):
    """Iterations per ms of a pure-Python loop on this thread while another
    thread waits in `torch.cuda.Event.synchronize` (as the serve loops'
    Finisher does in `Fetch.wait`), against the same loop while another
    thread sleeps as long (which releases the GIL).  A wait that held the
    GIL would leave the loop at ~0."""
    a = torch.randn(n, n, device=dev)
    a @ a
    torch.cuda.synchronize()

    def spin(thread):
        k = 0
        thread.start()
        while thread.is_alive():
            k += 1
        return k

    ev = torch.cuda.Event()
    for _ in range(reps):
        a @ a
    ev.record()
    t0 = time.perf_counter()
    busy = spin(threading.Thread(target=ev.synchronize))
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    asleep = spin(threading.Thread(target=time.sleep, args=(wait_s,)))
    sleep_s = time.perf_counter() - t0
    return {"wait_ms": wait_s * 1e3, "iters_per_ms_while_waiting": busy / (wait_s * 1e3),
            "iters_per_ms_while_sleeping": asleep / (sleep_s * 1e3),
            "ratio": (busy / wait_s) / (asleep / sleep_s)}


def serve_phases(torch, sw, v2, v3, native, batch, Query, wide, ns_line, ns_reply, dev):
    """The serving tier on the card: the stdin loop and the TCP server as
    subprocesses, then the same code in this process with the kernels'
    launch counts read around each wave.  Every phase prints one JSON line;
    a wrong or missing reply raises AssertionError."""
    from psa_torch.utils import cli as cli_mod
    from psa_torch.utils import server as server_mod
    from psa_torch.utils.io import parse_query_lines

    t_serve = time.perf_counter()
    w = SERVE
    rows = wide
    shared = [Query(q.weights, rows[0].seq1, q.seq2, q.is_max)
              for q in rows[:w["clients"] * w["closed_per_client"]]]
    t0 = time.perf_counter()
    want_rows = [reply_line(q, r) for q, r in
                 zip(rows, batch.search_batch(rows, backend="native"))]
    want_shared = [reply_line(q, r) for q, r in
                   zip(shared, batch.search_batch(shared, backend="native"))]
    expect_s = time.perf_counter() - t0
    row_lines = [serve_line(q) for q in rows]
    shared_lines = [serve_line(q) for q in shared]
    bad = bad_serve_lines(rows, w["bad_lines"])
    bad_ents = parse_query_lines(bad)
    assert all(isinstance(e, str) for e in bad_ents), bad_ents
    bad_want = ["error " + e for e in bad_ents]

    # serve_pipe: bad and blank lines among the 8192, in order
    pipe_in, pipe_want = [], []
    stride = len(row_lines) // w["bad_lines"]
    for i, (ln, rep) in enumerate(zip(row_lines, want_rows)):
        if i % stride == stride // 2:
            k = i // stride
            pipe_in += [bad[k], ""] if k % 2 else [bad[k]]
            pipe_want.append(bad_want[k])
        pipe_in.append(ln)
        pipe_want.append(rep)
    warm = row_lines[:2]
    sp = ServeProc(["--serve-batch", str(w["pipe_batch"])],
                   stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    t_start = time.perf_counter()
    sp.proc.stdin.write("\n".join(warm) + "\n")
    sp.proc.stdin.flush()
    got_warm = [sp.proc.stdout.readline().rstrip("\n") for _ in warm]
    ready_s = time.perf_counter() - t_start
    writer = threading.Thread(target=lambda: (sp.proc.stdin.write("\n".join(pipe_in) + "\n"),
                                              sp.proc.stdin.close()))
    t0 = time.perf_counter()
    writer.start()
    got, pipe_s = [], None
    for ln in sp.proc.stdout:
        got.append(ln.rstrip("\n"))
        if len(got) == len(pipe_want):
            pipe_s = time.perf_counter() - t0
    pipe_s = pipe_s or time.perf_counter() - t0
    writer.join(timeout=60)
    rc = sp.stop()
    n_bad = mismatches([got_warm, got], [want_rows[:2], pipe_want])
    log = sp.chunk_log()
    emit({"phase": "serve_pipe", "queries": len(row_lines), "bad_lines": len(bad),
          "serve_batch": w["pipe_batch"], "rc": rc, "mismatches": n_bad,
          "replies": len(got), "expected": len(pipe_want),
          "queries_per_s": len(row_lines) / pipe_s, "seconds": pipe_s,
          "start_to_first_replies_s": ready_s,
          "chunks": len(log), "chunk_ms_median": statistics.median(ms for _, ms in log)
          if log else None, "expected_replies_native_s": expect_s,
          "stderr_tail": "".join(sp.err)[-300:] if rc else ""})
    assert rc == 0 and n_bad == 0, f"serve_pipe: rc {rc}, {n_bad} mismatched replies"

    # serve_tcp: one server per depth, started together, their waves in
    # turns (2, 4, 4, 2); the closed loops and the long line on depth 2
    per = len(row_lines) // w["clients"]
    d0, d1 = w["depths"]
    srvs = {d: ServeProc(["--listen", "127.0.0.1:0", "--serve-batch", str(w["tcp_batch"])],
                         env_extra={"PSA_SERVE_INFLIGHT": str(d)}) for d in (d0, d1)}
    try:
        for srv in srvs.values():
            for lines, want in ((row_lines[:8], want_rows[:8]),
                                (shared_lines[:8], want_shared[:8])):
                warm_r, _, _ = tcp_clients(("127.0.0.1", srv.port), [lines], False)
                assert mismatches(warm_r, [want]) == 0, "serve_tcp warm-up"
        runs = {d: [] for d in srvs}
        for d in (d0, d1, d1, d0):
            srv = srvs[d]
            n_log = len(srv.chunk_log())
            replies, _, secs = tcp_clients(("127.0.0.1", srv.port),
                                           split(row_lines, w["clients"], per), False)
            n_bad = mismatches(replies, split(want_rows, w["clients"], per))
            assert n_bad == 0, f"serve_tcp depth {d}: {n_bad} mismatched replies"
            runs[d].append((len(row_lines) / secs, srv.chunk_log()[n_log:]))
        # depth 2 once more with the other server stopped: does an idle
        # serve process beside it cost anything?
        rc_other = srvs[d1].stop()
        srv = srvs[d0]
        n_log = len(srv.chunk_log())
        replies, _, secs = tcp_clients(("127.0.0.1", srv.port),
                                       split(row_lines, w["clients"], per), False)
        assert mismatches(replies, split(want_rows, w["clients"], per)) == 0, "serve_tcp alone"
        alone = (len(row_lines) / secs, srv.chunk_log()[n_log:])
        for d, got in runs.items():
            log = [c for _, one in got for c in one]
            emit({"phase": "serve_tcp", "depth": d, "clients": w["clients"],
                  "queries": len(row_lines), "serve_batch": w["tcp_batch"], "mismatches": 0,
                  "queries_per_s": [qps for qps, _ in got], "waves": len(got),
                  "chunks": len(log), "mean_chunk": statistics.mean(n for n, _ in log),
                  "chunk_ms_median": statistics.median(ms for _, ms in log),
                  **({"queries_per_s_other_server_stopped": alone[0],
                      "chunk_ms_median_other_server_stopped":
                      statistics.median(ms for _, ms in alone[1])} if d == d0 else
                     {"rc": rc_other})})
        srv, addr = srvs[d0], ("127.0.0.1", srvs[d0].port)
        cl = w["closed_per_client"]
        for name, lines, want in (("per_row", row_lines, want_rows),
                                  ("shared_s1", shared_lines, want_shared)):
            n_log = len(srv.chunk_log())
            replies, lat, secs = tcp_clients(addr, split(lines, w["clients"], cl), True)
            n_bad = mismatches(replies, split(want, w["clients"], cl))
            log = srv.chunk_log()[n_log:]
            emit({"phase": "serve_tcp_closed_loop", "workload": name, "depth": d0,
                  "clients": w["clients"], "queries": len(lat), "mismatches": n_bad,
                  "latency_ms": percentiles(lat), "queries_per_s": len(lat) / secs,
                  "chunks": len(log), "mean_chunk": statistics.mean(n for n, _ in log),
                  "chunk_ms_median": statistics.median(ms for _, ms in log),
                  "chunk_ms_p99": float(np.percentile([ms for _, ms in log], 99))})
            assert n_bad == 0, f"closed loop {name}: {n_bad} mismatched replies"
        replies, lat, _ = tcp_clients(addr, [[ns_line]], True)
        emit({"phase": "serve_long_line", "line_bytes": len(ns_line) + 1,
              "reply": replies[0][0][:40] + "...", "equal": replies == [[ns_reply]],
              "ms": lat[0]})
        assert replies == [[ns_reply]], "serve_long_line: not the north-star winner"
    finally:
        rcs = {d: srv.stop() for d, srv in srvs.items()}
    assert set(rcs.values()) == {0}, f"serve --listen exited {rcs}: " + "".join(
        ln for srv in srvs.values() for ln in srv.err)[-300:]

    # serve_kernels: the same serving code in this process; counts zeroed
    # just before each wave and read just after
    sizes: list = []
    real_dispatch = server_mod.dispatch_query_lines

    def counting(lines, **kw):
        sizes.append(len(lines))
        return real_dispatch(lines, **kw)

    server_mod.dispatch_query_lines = counting
    waves, latency = {}, {}
    n_auto = min(512, len(row_lines))
    try:
        def wave(name, fn):
            zero_launches(sw, v2, v3)
            native.calls.clear()
            del sizes[:]
            t0 = time.perf_counter()
            n_bad = fn()
            secs = time.perf_counter() - t0
            waves[name] = {**read_launches(sw, v2, v3), "native_calls": dict(native.calls),
                           "mismatches": n_bad, "dispatches": len(sizes),
                           "mean_chunk": statistics.mean(sizes) if sizes else None,
                           "seconds": secs}

        def stdin_wave():
            r, wfd = os.pipe()
            text = ("\n".join(row_lines[:2048]) + "\n").encode()
            writer = threading.Thread(target=lambda: (os.write(wfd, text), os.close(wfd)))
            out = io.StringIO()
            args = cli_mod.build_parser().parse_args(
                ["--serve", "--quiet", "--serve-batch", str(w["pipe_batch"])])
            cli_mod._fold_device_share(args)
            with os.fdopen(r, "rb", buffering=0) as rf, contextlib.redirect_stdout(out):
                writer.start()
                rc = cli_mod._serve_loop(args, cli_mod._ServeLineReader(rf), dev)
            writer.join(timeout=60)
            assert rc == 0, f"_serve_loop exited {rc}"
            return mismatches([out.getvalue().splitlines()], [want_rows[:2048]])

        def tcp_wave(lines, want, closed, backend="torch"):
            srv = server_mod.TCPQueryServer("127.0.0.1", 0, backend=backend, lenient=False,
                                            json_out=False, device=dev,
                                            max_batch=w["tcp_batch"], quiet=True)
            n = len(lines) // w["clients"]
            replies, lat, _ = serve_in_process(srv, split(lines, w["clients"], n), closed)
            if lat:
                latency[backend] = percentiles(lat)
            return mismatches(replies, split(want, w["clients"], n))

        wave("stdin_per_row", stdin_wave)
        wave("tcp_per_row", lambda: tcp_wave(row_lines[:2048], want_rows[:2048], False))
        wave("tcp_shared_s1", lambda: tcp_wave(shared_lines, want_shared, False))
        wave("tcp_closed_loop_auto", lambda: tcp_wave(row_lines[:n_auto], want_rows[:n_auto],
                                                       True, backend="auto"))
    finally:
        server_mod.dispatch_query_lines = real_dispatch
    for name in ("stdin_per_row", "tcp_per_row", "tcp_shared_s1"):
        wv = waves[name]
        assert wv["mismatches"] == 0, f"serve_kernels {name}: mismatched replies"
        kernel = "sweep_batched_shared" if name == "tcp_shared_s1" else "sweep_batched"
        assert wv[kernel] > 0, f"serve_kernels {name}: {kernel} never launched"
        assert wv["native_calls"].get("parse_chunk", 0) > 0, f"{name}: the native parser did not run"
        assert wv["native_calls"].get("search", 0) == 0, f"{name}: a host engine answered"

    # does a thread waiting on a CUDA event let this thread run? The loop's
    # Python iterations per ms while another thread waits on the event of
    # ~0.1 s of queued matmuls, against the same loop alone
    gil = event_wait_gil(torch, dev)
    emit({"phase": "serve_event_wait_gil", **gil})
    assert gil["ratio"] > 0.5, f"the event wait holds the GIL: {gil}"

    # one 256-line chunk traced through dispatch and finish
    chunk = row_lines[:w["tcp_batch"]]

    def one_chunk():
        outs = server_mod.dispatch_query_lines(chunk, backend="torch", lenient=False,
                                               json_out=False, device=dev).finish()[0]
        assert outs == want_rows[:len(chunk)], "the traced chunk's replies differ"

    one_chunk()
    traced_ms, busy_ms, top = traced_busy(torch, one_chunk)
    emit({"phase": "serve_kernels", "waves": {k: v for k, v in waves.items()
                                             if k != "tcp_closed_loop_auto"},
          "launches_per_wave": "counts zeroed just before each wave, read just after",
          "traced_chunk": {"lines": len(chunk), "traced_ms": traced_ms,
                           "device_busy_ms": busy_ms if busy_ms > 0 else None,
                           "device_busy_share": busy_ms / traced_ms if busy_ms > 0 else None,
                           "device_top": top}})
    auto = waves["tcp_closed_loop_auto"]
    emit({"phase": "serve_auto", "queries": n_auto, "clients": w["clients"],
          "mismatches": auto["mismatches"], "latency_ms": latency["auto"],
          "native_search_calls": auto["native_calls"].get("search", 0),
          "sweep_batched": auto["sweep_batched"],
          "sweep_batched_shared": auto["sweep_batched_shared"],
          "dispatches": auto["dispatches"], "mean_chunk": auto["mean_chunk"],
          "answered_by": ("native" if auto["sweep_batched"] + auto["sweep_batched_shared"] == 0
                          else "card" if not auto["native_calls"].get("search") else "both")})
    assert auto["mismatches"] == 0, "serve_auto: mismatched replies"

    # where a chunk's time goes: parse, dispatch, finish, format (median ms)
    for n in (w["pipe_batch"], w["tcp_batch"], w["clients"]):
        lines = row_lines[:n]
        ph = {k: [] for k in ("parse", "dispatch", "finish", "format", "total")}
        for it in range(7):
            t = [time.perf_counter()]
            ents = parse_query_lines(lines)
            t.append(time.perf_counter())
            handles, fin = batch.search_batch_async(ents, backend="torch",
                                                    strict_alphabet=False, device=dev)
            t.append(time.perf_counter())
            res = fin()
            t.append(time.perf_counter())
            outs = [reply_line(q, r) for q, r in zip(ents, res)]
            t.append(time.perf_counter())
            if it >= 2:
                for k, a, b in zip(list(ph)[:4], t, t[1:]):
                    ph[k].append((b - a) * 1e3)
                ph["total"].append((t[-1] - t[0]) * 1e3)
        assert outs == want_rows[:n], "the timed chunk's replies differ"
        emit({"phase": "serve_chunk_split_ms", "lines": n, "runs": 5,
              **{k: statistics.median(v) for k, v in ph.items()}})
    emit({"phase": "serve_elapsed", "seconds": time.perf_counter() - t_serve})
    return waves


# Long Seq2 end to end (the JAX package's long-Seq2 check, README.md's
# 600k x 250k): random_sequences(600_000, 250_000, seed=2), weights 1 3 4 2,
# minimum; through `torch`, through `search_sharded_auto` on a mesh of 4
# shards of the one card, and through the native engine once.
LONG_SEQ2 = dict(n1=600_000, n2=250_000, seed=2, shards=4)
# The mesh shapes the north star runs on (every shard on cuda:0): 1-D shard
# counts, 2-D (n_op, n_ch) grids, and search_sharded_auto over 4 shards.
SHARDED_1D = (1, 2, 4, 8)
SHARDED_2D = ((1, 2), (2, 2), (1, 4), (2, 4))
# All-'A' massive ties: every offset ties exactly, so no shard's top k can
# certify the winner and the full-stats fallback must run.
TIES = dict(n1=200_000, n2=2048, shards=4)


def winner(r):
    return (r.offset, r.char_offset, r.sub_code, r.score)


def same_bits(a, b) -> bool:
    return winner(a)[:3] == winner(b)[:3] and a.score.hex() == b.score.hex()


def sharded_phases(torch, sw, v2, v3, mesh_mod, batch, eng, eng_native,
                   tables, s1, s2, encode, random_sequences, bq, bres):
    """The sharded paths (psa_torch/parallel/mesh.py, search_batch(mesh=))
    in this process, every shard on cuda:0; the launch counts and the
    fallback count are zeroed just before each path and read just after.
    Every phase prints one JSON line; a wrong winner or count raises
    AssertionError."""
    from psa_torch.core.tables import device_tables_cached

    cuda0 = torch.device("cuda", 0)
    c1, c2 = encode(s1), encode(s2)
    runs = []
    cases = ([("1d", n, n, lambda n=n: mesh_mod.search_sharded(
                  c1, c2, tables, [cuda0] * n)) for n in SHARDED_1D]
             + [("2d", list(s), s[0] * s[1], lambda s=s: mesh_mod.search_sharded_2d(
                  c1, c2, tables, mesh_mod.make_mesh_2d([cuda0] * (s[0] * s[1]), *s)))
                for s in SHARDED_2D]
             + [("auto", 4, 4, lambda: mesh_mod.search_sharded_auto(
                  c1, c2, tables, [cuda0] * 4))])
    for kind, shape, shards, fn in cases:
        zero_launches(sw, v2, v3)
        mesh_mod.fallbacks = 0
        got = winner(fn())
        launches = read_launches(sw, v2, v3)
        fell = mesh_mod.fallbacks
        if got != NORTH_STAR_WINNER or launches["sweep"] != shards or fell:
            raise AssertionError(f"north star sharded {kind} {shape}: {got}, "
                                 f"{launches['sweep']} sweep launches, "
                                 f"{fell} fallbacks")
        med, lo, hi = wall_ms(fn, runs=5)
        runs.append({"mesh": kind, "shape": shape, "shards": shards,
                     "winner": list(got), "sweep_launches": launches["sweep"],
                     "ms": med, "min": lo, "max": hi})
    med, lo, hi = wall_ms(lambda: eng.search_codes(c1, c2), runs=5)
    emit({"phase": "sharded", "query": "north_star", "runs": 5, "meshes": runs,
          "auto_shape": list(mesh_mod.mesh_shape(4, c1.shape[0] - c2.shape[0] + 1,
                                                 c2.shape[0])),
          "unsharded_engine_ms": med, "unsharded_min": lo, "unsharded_max": hi,
          "note": "shards share one card: overhead per shard, not scaling"})

    z1 = np.zeros(TIES["n1"], np.int32)
    z2 = np.zeros(TIES["n2"], np.int32)
    want = eng_native.search_codes(z1, z2)
    for kind, fn in (("1d", lambda: mesh_mod.search_sharded(
                         z1, z2, tables, [cuda0] * TIES["shards"])),
                     ("2d", lambda: mesh_mod.search_sharded_2d(
                         z1, z2, tables, mesh_mod.make_mesh_2d([cuda0] * 4, 2, 2)))):
        zero_launches(sw, v2, v3)
        mesh_mod.fallbacks = 0
        t0 = time.perf_counter()
        got = fn()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches(sw, v2, v3)
        emit({"phase": "sharded_fallback", "mesh": kind, "n1": TIES["n1"],
              "n2": TIES["n2"], "shards": 4, "winner": list(winner(got)),
              "native": list(winner(want)), "fallbacks": mesh_mod.fallbacks,
              "sweep_launches": launches["sweep"], "ms": ms})
        if not same_bits(got, want) or mesh_mod.fallbacks != 1 \
                or launches["sweep"] != 8:
            raise AssertionError(f"all-'A' ties through the {kind} mesh: "
                                 f"{winner(got)} vs native {winner(want)}, "
                                 f"{mesh_mod.fallbacks} fallbacks")

    s1l, s2l = random_sequences(LONG_SEQ2["n1"], LONG_SEQ2["n2"], seed=LONG_SEQ2["seed"])
    c1l, c2l = encode(s1l), encode(s2l)
    noff = c1l.shape[0] - c2l.shape[0] + 1
    mesh4 = [cuda0] * LONG_SEQ2["shards"]
    shape = mesh_mod.mesh_shape(len(mesh4), noff, c2l.shape[0])
    long = {}
    for tag, fn, shards in (
            ("torch", lambda: eng.search_codes(c1l, c2l), 1),
            ("sharded_auto", lambda: mesh_mod.search_sharded_auto(c1l, c2l, tables, mesh4),
             LONG_SEQ2["shards"])):
        zero_launches(sw, v2, v3)
        mesh_mod.fallbacks = 0
        t0 = time.perf_counter()
        r = fn()
        first = (time.perf_counter() - t0) * 1e3
        launches = read_launches(sw, v2, v3)
        fell = mesh_mod.fallbacks
        med, lo, hi = wall_ms(fn, runs=3, warm=0)
        long[tag] = dict(result=r, first_ms=first, ms=med, min=lo, max=hi,
                         sweep_launches=launches["sweep"], fallbacks=fell)
        if launches["sweep"] < shards:
            raise AssertionError(f"600k x 250k through {tag} launched sweep "
                                 f"{launches['sweep']} times")
    t0 = time.perf_counter()
    want = eng_native.search_codes(c1l, c2l)
    native_ms = (time.perf_counter() - t0) * 1e3
    _, _, l2p, l1k = sw.plan_shapes(c1l.shape[0], c2l.shape[0])
    dtabs = device_tables_cached(tables, cuda0)
    packed, _ = batch.run_exact(sw.upload_codes(c1l, l1k, cuda0),
                                sw.upload_codes(c2l, l2p, cuda0), noff, dtabs)
    near = int(batch.unpack_epilogue_outputs(packed.cpu().numpy(), batch.TOPK)[2][0])
    emit({"phase": "long_seq2", "n1": LONG_SEQ2["n1"], "n2": LONG_SEQ2["n2"],
          "pair_evals": float(noff) * LONG_SEQ2["n2"],
          "native": list(winner(want)), "native_ms": native_ms,
          "near": near, "near_gt_k": near > batch.TOPK,
          "eps_f32": dtabs.eps(l2p), "auto_shape": list(shape),
          **{tag: {"winner": list(winner(v["result"])),
                   "equal_bits": same_bits(v["result"], want),
                   **{k: v[k] for k in ("first_ms", "ms", "min", "max",
                                        "sweep_launches", "fallbacks")}}
             for tag, v in long.items()}})
    for tag, v in long.items():
        if not same_bits(v["result"], want):
            raise AssertionError(f"600k x 250k through {tag} differs from native")

    for name, qs in bq.items():
        zero_launches(sw, v2, v3)
        got = batch.search_batch(qs, mesh=[cuda0] * 4)
        launches = read_launches(sw, v2, v3)
        kernel = "sweep_batched_shared" if name == "shared_s1" else "sweep_batched"
        med, lo, hi = wall_ms(lambda: batch.search_batch(qs, mesh=[cuda0] * 4), runs=5)
        umed, ulo, uhi = wall_ms(lambda: batch.search_batch(qs), runs=5)
        emit({"phase": "sharded_batch", "workload": name, "queries": len(qs),
              "mesh": 4, "equal_unsharded": got == bres[name], **launches,
              "ms": med, "min": lo, "max": hi, "unsharded_ms": umed,
              "unsharded_min": ulo, "unsharded_max": uhi, "runs": 5})
        if got != bres[name] or launches[kernel] != 4:
            raise AssertionError(f"sharded batch {name}: equal {got == bres[name]}, "
                                 f"{launches[kernel]} {kernel} launches")


DIST_CMD = [sys.executable, "-m", "psa_torch.utils.launcher", "-np", "2"]


def run_ranks(cmds, timeout: int):
    """Start every command at once, then wait for each under its own
    timeout -> [(rc, stdout, stderr, seconds)]."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def distributed_phases(inp: Path, want_bytes: str, cases_txt: Path, want_files: dict,
                       work: Path):
    """Two ranks on cuda:0 joined by Gloo: once started directly (each
    rank's device and the group's backend read from its stderr), then
    through `python -m psa_torch.utils.launcher -np 2` on the north-star
    file, the mixed --batch file, --batch --sharded, and a bad input; each
    output byte-equal to one process's.  Then `psa-torch --sharded` on the
    north-star file.  Raises AssertionError on a difference."""
    from psa_torch.utils.launcher import _free_port

    out = work / "dist_direct.txt"
    out.unlink(missing_ok=True)
    base = [sys.executable, "-m", "psa_torch.utils.cli", "--distributed",
            "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "2",
            "-o", str(out)]
    ranks = run_ranks([base + ["--process-id", "0", str(inp)],
                       base + ["--process-id", "1", str(work / "never-read.txt")]],
                      timeout=300)
    lines = [next((ln for ln in e.splitlines() if ln.startswith("[dist]")), None)
             for _, _, e, _ in ranks]
    ok = ([rc for rc, *_ in ranks] == [0, 0] and out.is_file()
          and out.read_text() == want_bytes)
    trailer = [ln for ln in ranks[0][1].splitlines() if ln.startswith("total time:")]
    emit({"phase": "distributed", "run": "direct_north_star",
          "rcs": [rc for rc, *_ in ranks], "rank_lines": lines,
          "rank0_flow_s": float(trailer[0].split()[-1]) if trailer else None,
          "bytes_equal": ok, "seconds": ranks[-1][3],
          "stderr_tail": [e[-300:] for _, _, e, _ in ranks]})
    if not ok or None in lines:
        raise AssertionError("two ranks on the north star differ from one process")

    runs = [("north_star", [str(inp), "-o", str(work / "dist_ns.txt")], 0),
            ("batch", [str(cases_txt), "--batch", "--lenient", "-o",
                       str(work / "dist_batch")], 1),
            ("batch_sharded", [str(cases_txt), "--batch", "--sharded", "--lenient",
                               "-o", str(work / "dist_batch_sharded")], 1),
            ("bad_input", [str(work / "missing.txt"), "-o",
                           str(work / "dist_bad.txt")], 2)]
    for name, argv, want_rc in runs:
        target = Path(argv[argv.index("-o") + 1])
        if target.is_dir():
            shutil.rmtree(target)
        target.unlink(missing_ok=True)
        (rc, o, e, secs), = run_ranks([DIST_CMD + argv + ["--quiet"]], timeout=600)
        if name == "north_star":
            equal = target.is_file() and target.read_text() == want_bytes
        elif name == "bad_input":
            equal = not target.exists() and "cannot open input file" in e
        else:
            got = {f.name: f.read_bytes() for f in sorted(target.glob("out_*.txt"))}
            equal = got == want_files
        emit({"phase": "distributed", "run": f"launcher_{name}", "rc": rc,
              "want_rc": want_rc, "bytes_equal": equal, "seconds": secs,
              "stderr_tail": e[-400:]})
        if rc != want_rc or not equal:
            raise AssertionError(f"psa-torch-dist -np 2 {name}: rc {rc}, "
                                 f"equal {equal}")

    out = work / "cli_sharded.txt"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "psa_torch.utils.cli", str(inp),
                        "--sharded", "-o", str(out), "--quiet"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    equal = p.returncode == 0 and out.is_file() and out.read_text() == want_bytes
    emit({"phase": "cli_sharded", "rc": p.returncode, "bytes_equal": equal,
          "seconds": time.perf_counter() - t0, "stderr_tail": p.stderr[-300:]})
    if not equal:
        raise AssertionError("psa-torch --sharded differs from the unsharded CLI")


def main() -> int:
    t_start = time.perf_counter()
    if not (ROOT / "psa_torch" / "csrc" / "sweep.cu").is_file():
        return fail(f"no psa_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")

    from psa_torch import native
    from psa_torch.config import CONFIG
    from psa_torch.core import alphabet
    from psa_torch.core.alphabet import encode
    from psa_torch.core.tables import build_tables, device_tables
    from psa_torch.models import batch
    from psa_torch.models.search import AlignmentSearchEngine
    from psa_torch.ops import _sweep_v2 as v2
    from psa_torch.ops import _sweep_v3 as v3
    from psa_torch.ops import sweep as sw
    from psa_torch.utils import generator, kernel_lab
    from psa_torch.utils.generator import random_sequences, write_input_file
    from psa_torch.utils.kernel_lab import cuda_ms, dispatch_ms
    from psa_torch.utils.io import Query, format_output

    if not Path(sw.__file__).resolve().is_relative_to(ROOT):
        return fail(f"psa_torch imported from outside {ROOT}")
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    lib = sw.build_library()
    build_s = time.perf_counter() - t0
    logs = sorted((sw._BUILD_DIR).glob("*.log"))
    ptxas = [ln.strip() for ln in (logs[-1].read_text().splitlines() if logs else [])
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit({"phase": "build", "seconds": build_s, "library": Path(lib._name).name,
          "ptxas": ptxas})
    sass = kernel_lab.sass_loop_mix(kernel_lab.sass_of(lib._name))
    emit({"phase": "sass_loop_mix", "kernels": sass})
    host = host_engine_phase(torch, native)
    emit(host)
    if host["engine"] != "native":
        return fail(f"the native host engine did not build: {host['error']}")

    # 3. kernels vs their plain versions, on the card
    t_ns = build_tables(np.array(NORTH_STAR["weights"]), False)
    code = torch.from_numpy(t_ns.code).to(dev)
    rng = np.random.default_rng(2024)
    try:
        max_abs = sweep_checks(torch, sw, code, dev)
        batched_abs, (big1, big2) = batched_kernel_checks(torch, sw, code, dev)
        lab_abs = lab_kernel_checks(torch, sw, v2, v3, code, dev)
    except AssertionError as e:
        return fail(str(e))

    # 4. the single-query path, end to end; the launch counts are read
    # around it only
    s1, s2 = random_sequences(NORTH_STAR["n1"], NORTH_STAR["n2"],
                              seed=NORTH_STAR["seed"])
    zero_launches(sw, v2, v3)
    native.calls.clear()
    eng = AlignmentSearchEngine(NORTH_STAR["weights"], NORTH_STAR["is_max"],
                                backend="torch")
    t0 = time.perf_counter()
    res = eng.search(s1, s2)
    first_s = time.perf_counter() - t0
    got = (res.offset, res.char_offset, res.sub_code, res.score)
    emit({"phase": "north_star", "winner": list(got), "first_call_s": first_s})
    if got != NORTH_STAR_WINNER:
        return fail(f"north star winner {got} != {NORTH_STAR_WINNER}")
    ns_result = res

    work = ROOT / "psa_torch" / "_build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    inp, outp = work / "input.txt", work / "output.txt"
    write_input_file(str(inp), NORTH_STAR["weights"], s1, s2, NORTH_STAR["is_max"])
    outp.unlink(missing_ok=True)
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "psa_torch.utils.cli", str(inp),
                          "-o", str(outp), "--quiet"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    want_bytes = format_output(res.mutant(s2), res.offset, res.score)
    cli_ok = (cli.returncode == 0 and outp.is_file()
              and outp.read_text() == want_bytes)
    emit({"phase": "cli", "rc": cli.returncode, "bytes_equal": cli_ok,
          "seconds": cli_s, "stderr_tail": cli.stderr[-400:]})
    if not cli_ok:
        return fail("psa_torch CLI output differs from format_output of the winner")
    small_s1, small_s2 = random_sequences(20_000, 2000, seed=3, hyphen_p=0.05)
    small_inp = work / "small.txt"
    write_input_file(str(small_inp), (2.0, 1.0, 5.0, 0.5), small_s1, small_s2, True)
    outs = {}
    for tag, extra in (("numpy", ["--backend", "numpy"]),
                       ("native", ["--backend", "native"]),
                       ("auto", ["--backend", "auto"]),
                       ("hybrid_50", ["--backend", "hybrid", "--device-share", "50"]),
                       ("share_-100", ["--device-share", "-100"])):
        o = work / f"small_{tag}.txt"
        o.unlink(missing_ok=True)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "psa_torch.utils.cli",
                               str(small_inp), "-o", str(o), "--quiet", *extra],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        outs[tag] = o.read_bytes() if proc.returncode == 0 and o.is_file() else None
        emit({"phase": "cli_backend", "backend": tag, "argv": extra,
              "rc": proc.returncode, "seconds": time.perf_counter() - t0,
              "bytes_equal_numpy": outs[tag] == outs["numpy"],
              "stderr_tail": proc.stderr[-300:]})
        if outs[tag] is None or outs[tag] != outs["numpy"]:
            return fail(f"psa-torch {' '.join(extra)} differs from --backend numpy")

    qrng = np.random.default_rng(7)
    queries = [((1.0, 3.0, 4.0, 2.0), False, 20000, 2000, 0.0),
               ((1.0, 3.0, 4.0, 2.0), True, 15000, 1500, 0.02),
               ((1.0, 1.0, 1.0, 1.0), False, 12000, 2000, 0.0),
               ((0.0, 0.0, 0.0, 0.0), True, 8000, 500, 0.05),
               ((5.0, 1.0, 1.0, 1.0), True, 20000, 1000, 0.0),
               ((-1.0, 2.0, -3.0, 4.0), False, 10000, 777, 0.03)]
    for w, is_max, n1, n2, hp in queries:
        c1 = random_codes(qrng, n1, hp)
        c2 = random_codes(qrng, n2, hp)
        a = AlignmentSearchEngine(w, is_max, backend="torch").search_codes(c1, c2)
        b = AlignmentSearchEngine(w, is_max, backend="numpy").search_codes(c1, c2)
        ta = (a.offset, a.char_offset, a.sub_code, a.score)
        tb = (b.offset, b.char_offset, b.sub_code, b.score)
        emit({"phase": "differential", "weights": w, "is_max": is_max,
              "n1": n1, "n2": n2, "card": list(ta), "numpy": list(tb)})
        if ta != tb:
            return fail(f"card {ta} != numpy {tb}")
    single_launches = read_launches(sw, v2, v3)
    single_native = dict(native.calls)
    emit({"phase": "main_path_launches", "path": "single_query", **single_launches,
          "native_calls": single_native})
    if single_launches["sweep"] < 1 + len(queries):
        return fail("the single-query path did not go through the sweep kernel")
    if single_native.get("rescore_batch", 0) < 1 + len(queries):
        return fail("host selection of the single-query path did not run native")

    # 4a. the north-star query through every backend setting, each with the
    # counts zeroed just before it and read just after
    ns_engines = {}
    for backend, share in NS_BACKENDS:
        tag = backend if share is None else f"{backend}_{share:g}"
        ns_engines[tag] = AlignmentSearchEngine(
            NORTH_STAR["weights"], NORTH_STAR["is_max"], backend=backend,
            device_share=share)
        zero_launches(sw, v2, v3)
        native.calls.clear()
        r = ns_engines[tag].search(s1, s2)
        got = (r.offset, r.char_offset, r.sub_code, r.score)
        launches = read_launches(sw, v2, v3)
        calls = dict(native.calls)
        emit({"phase": "main_path_launches", "path": f"north_star_{tag}",
              "winner": list(got), **launches, "native_calls": calls})
        if got != NORTH_STAR_WINNER:
            return fail(f"north star through {tag}: {got} != {NORTH_STAR_WINNER}")
        on_card = tag in ("torch", "auto", "hybrid_50", "hybrid_100")
        if launches["sweep"] != (1 if on_card else 0):
            return fail(f"north star through {tag} launched sweep "
                        f"{launches['sweep']} times")
        if on_card and calls.get("rescore_batch", 0) != 1:
            return fail(f"host selection of {tag} did not run native")
        if not on_card and calls.get("search", 0) != 1:
            return fail(f"{tag} did not run the native engine")

    # 4b. the batch path, end to end: 1024 queries with their own Seq1 and
    # 1024 reads against one shared Seq1; the launch counts are read around
    # the two search_batch calls only
    from psa_torch.models.batch import search_batch

    bq = {"per_row": batch_queries(Query, random_sequences, shared=False),
          "shared_s1": batch_queries(Query, random_sequences, shared=True)}
    # 8 microbatches in flight together: seeds 0..8191, of which the first
    # 1024 are the per-row workload
    wide = batch_queries(Query, random_sequences, shared=False, b=8 * BATCH["b"])
    bres, first = {}, {}
    zero_launches(sw, v2, v3)
    native.calls.clear()
    for name, qs in bq.items():
        t0 = time.perf_counter()
        bres[name] = search_batch(qs)
        first[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide_res = search_batch(wide)
    wide_s = time.perf_counter() - t0
    batch_launches = read_launches(sw, v2, v3)
    batch_native = dict(native.calls)
    emit({"phase": "main_path_launches", "path": "batch", **batch_launches,
          "native_calls": batch_native})
    if batch_launches["sweep_batched"] < 1 or batch_launches["sweep_batched_shared"] < 1:
        return fail("the batch path did not go through both batched kernels")
    if min(batch_native.get(k, 0) for k in ("rescore_multi", "encode_padded")) < 1:
        return fail("the batch path's host prep or selection did not run native")
    emit({"phase": "batch_8_microbatches", "queries": len(wide),
          "first_call_s": wide_s, "first_1024_equal": wide_res[:BATCH["b"]] == bres["per_row"]})
    if wide_res[:BATCH["b"]] != bres["per_row"]:
        return fail("the 8-microbatch batch differs from the one-microbatch batch")
    srng = np.random.default_rng(64)
    for name, qs in bq.items():
        sample = sorted(srng.choice(len(qs), 64, replace=False).tolist())
        want = search_batch([qs[i] for i in sample], backend="numpy")
        want_native = search_batch([qs[i] for i in sample], backend="native")
        got = [bres[name][i] for i in sample]
        emit({"phase": "batch_vs_numpy", "workload": name, "queries": len(qs),
              "sampled": len(sample), "equal": got == want,
              "equal_native": got == want_native,
              "first_call_s": first[name],
              "no_mutation": sum(r is None for r in bres[name]),
              "winner_0": [got[0].offset, got[0].char_offset, got[0].sub_code,
                           got[0].score] if got[0] else None})
        if got != want or got != want_native:
            return fail(f"batch path {name} differs from the numpy or native backend")

    bdir = ROOT / "psa_torch" / "_build" / "smoke_batch"
    bdir.mkdir(parents=True, exist_ok=True)
    cases_txt = bdir / "cases.txt"
    n_cases = write_batch_cases(cases_txt, generator, random_sequences)
    runs = {}
    for tag, extra in (("card", []), ("numpy", ["--backend", "numpy"]),
                       ("auto", ["--backend", "auto"])):
        out = bdir / f"outs_{tag}"
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "psa_torch.utils.cli",
                               str(cases_txt), "--batch", "--lenient", "--quiet",
                               "-o", str(out), *extra], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        runs[tag] = (proc, time.perf_counter() - t0,
                     {f.name: f.read_bytes() for f in sorted(out.glob("out_*.txt"))})
    (pc, pc_s, fc), (pn, pn_s, fn), (pa, pa_s, fa) = (runs["card"], runs["numpy"],
                                                      runs["auto"])
    cli_batch_ok = (pc.returncode == pn.returncode == pa.returncode == 1
                    and len(fc) == n_cases and fc == fn and fa == fn)
    emit({"phase": "cli_batch", "cases": n_cases, "rc_card": pc.returncode,
          "rc_numpy": pn.returncode, "rc_auto": pa.returncode, "files": len(fc),
          "bytes_equal": fc == fn, "bytes_equal_auto": fa == fn,
          "seconds_card": pc_s, "seconds_numpy": pn_s, "seconds_auto": pa_s,
          "stderr_tail": pc.stderr[-400:] + pa.stderr[-400:]})
    if not cli_batch_ok:
        return fail("psa-torch --batch (card or auto) differs from its numpy backend")
    # the same file through search_batch in this process: one batched launch
    # per microbatch of each bucket, the buckets keyed on offsets rounded to
    # 1024 (as before the sweep's tiles shrank to 256)
    from psa_torch.utils.io import read_cases

    file_cases = read_cases(str(cases_txt))
    buckets = {}
    for q in file_cases:
        noff, l2p = len(q.seq1) - len(q.seq2) + 1, -(-max(len(q.seq2), 1) // 32) * 32
        key = (tuple(float(w) for w in q.weights), q.is_max,
               -(-noff // 1024) * 1024 + l2p, l2p)
        buckets[key] = buckets.get(key, 0) + 1
    want_launches = sum(-(-n // CONFIG.micro_batch) for n in buckets.values())
    zero_launches(sw, v2, v3)
    search_batch(file_cases, strict_alphabet=False)
    file_launches = read_launches(sw, v2, v3)
    got_launches = file_launches["sweep_batched"] + file_launches["sweep_batched_shared"]
    emit({"phase": "main_path_launches", "path": "batch_file", "cases": len(file_cases),
          "buckets": len(buckets), "batched_launches_expected": want_launches,
          **file_launches})
    if got_launches != want_launches:
        return fail(f"search_batch took {got_launches} batched launches on the "
                    f"{len(file_cases)}-case file, not {want_launches}")

    # 4c. the kernel-lab path: its command line once, beside this process's
    # oracle of the lab's query; then v1, v2 and v3 in turns with --check,
    # the launch counts read around the rounds only
    lab_cli = lab_cli_beside_oracle(kernel_lab)
    emit(lab_cli)
    if lab_cli["rc"] != 0 or not (lab_cli["result"] or "").startswith("RESULT v3 "):
        return fail("python -m psa_torch.utils.kernel_lab --variant v3 failed")
    zero_launches(sw, v2, v3)
    try:
        lab_ms = lab_rounds(kernel_lab)
    except AssertionError as e:
        return fail(str(e))
    lab_launches = read_launches(sw, v2, v3)
    emit({"phase": "main_path_launches", "path": "kernel_lab", **lab_launches})
    if min(lab_launches[k] for k in ("sweep", "sweep_v2", "sweep_v3")) < 1:
        return fail("the kernel lab did not go through the v1, v2 and v3 kernels")
    emit({"phase": "lab_interleaved_ms", "n1": LAB["n1"], "n2": LAB["n2"],
          "iters": LAB["iters"], "rounds": LAB["rounds"], **lab_ms,
          "median": {v: statistics.median(t) for v, t in lab_ms.items()}})

    # 4d. the serving tier: `--serve` through OS pipes and `--serve --listen`
    # as subprocesses, then the same code in this process, its kernel
    # launches counted per wave
    ns_query = Query(np.array(NORTH_STAR["weights"]), s1, s2, NORTH_STAR["is_max"])
    try:
        serve_phases(torch, sw, v2, v3, native, batch, Query, wide,
                     serve_line(ns_query), reply_line(ns_query, ns_result), dev)
    except AssertionError as e:
        return fail(str(e))

    # 4e. the sharded and multi-process paths: the north star on meshes of
    # 1-8 shards of the one card (1-D and 2-D), the all-'A' fallback, 600k x
    # 250k through `torch` and a 4-shard mesh against native, the batch
    # workload sharded over 4, then two ranks on the card and --sharded
    from psa_torch.parallel import mesh as mesh_mod

    t_par = time.perf_counter()
    try:
        sharded_phases(torch, sw, v2, v3, mesh_mod, batch, eng, ns_engines["native"],
                       eng.tables, s1, s2, encode, random_sequences, bq, bres)
        distributed_phases(inp, want_bytes, cases_txt, fn, work)
    except AssertionError as e:
        return fail(str(e))
    emit({"phase": "parallel_elapsed", "seconds": time.perf_counter() - t_par})

    # 5. times on the card
    timings = {}
    for name, n1, n2 in (("bench", 131072, 8192), ("north_star", 100_000, 10_000),
                         ("long_seq1", 400_000, 2048), ("seq1_1M", 1_000_000, 2048)):
        c1 = random_codes(rng, n1)
        c2 = random_codes(rng, n2)
        noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
        d1 = sw.upload_codes(c1, l1k, dev)
        d2 = sw.upload_codes(c2, l2p, dev)
        (k_ms, k_q1, k_q3), (k_bb, bb_q1, bb_q3) = kernel_times(
            torch, lambda: sw.sweep(d1, d2, code), runs=20)
        p_ms, p_q1, p_q3 = cuda_ms(torch, lambda: sw.sweep_plain(d1, d2, code),
                                   runs=10, warm=1)
        bound_ms, bound_by = single_bound(noff, n2, l1k, l2p, noff_pad)
        pairs = float(noff) * n2
        padded_pairs = float(noff_pad) * l2p
        timings[name] = dict(ms=k_ms, ms_back_to_back=k_bb, plain_ms=p_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "sweep_time", "case": name, "n1": n1, "n2": n2,
              "kernel_ms": k_ms, "kernel_ms_iqr": [k_q1, k_q3],
              "kernel_ms_back_to_back": k_bb, "back_to_back_iqr": [bb_q1, bb_q3],
              "pair_evals_per_s": pairs / (k_ms * 1e-3),
              "plain_ms": p_ms, "plain_ms_iqr": [p_q1, p_q3],
              "bound_ms": bound_ms, "bound_by": bound_by,
              "padded_pairs": padded_pairs,
              "dispatch_ms": dispatch_ms(sass, "sweep_kernel", padded_pairs),
              "plan": split_plan(sw, noff_pad, l2p),
              "runs": 20, "back_to_back": KERNEL_BACK_TO_BACK, "plain_runs": 10})

    c1n, c2n = encode(s1), encode(s2)
    noff, _, l2p, l1k = sw.plan_shapes(c1n.shape[0], c2n.shape[0])
    dtabs = device_tables(eng.tables, dev)
    split = {k: [] for k in ("upload", "sweep", "epilogue", "fetch", "host_select", "total")}
    for it in range(12):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        d1 = sw.upload_codes(c1n, l1k, dev)
        d2 = sw.upload_codes(c2n, l2p, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        stats5 = sw.sweep(d1, d2, dtabs.code)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        packed = batch.pack_epilogue_outputs(*batch.exact_topk_epilogue_rows(
            stats5[None], dtabs, noff, l2p))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        buf = packed.cpu().numpy()
        t.append(time.perf_counter())
        r = batch.host_select(c1n, c2n, noff, eng.tables, buf, stats5)
        t.append(time.perf_counter())
        if (r.offset, r.char_offset, r.sub_code, r.score) != NORTH_STAR_WINNER:
            return fail("north star winner changed in the timed runs")
        if it >= 2:
            for name, a, b in zip(list(split)[:5], t, t[1:]):
                split[name].append((b - a) * 1e3)
            split["total"].append((t[-1] - t[0]) * 1e3)
    e2e = {k: statistics.median(v) for k, v in split.items()}
    emit({"phase": "north_star_split_ms", **e2e, "runs": len(split["total"]),
          "host_engine": native.host_engine()})

    # the same query through the engine, unsynchronised between phases, and
    # one traced run for the device's busy time
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.search(s1, s2)
        walls.append((time.perf_counter() - t0) * 1e3)
    traced_ms, busy_ms, top = traced_busy(torch, lambda: eng.search(s1, s2))
    emit({"phase": "north_star_engine_ms", "median": statistics.median(walls),
          "min": min(walls), "max": max(walls), "runs": len(walls),
          "traced_ms": traced_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else None,
          "device_idle_share": 1 - busy_ms / traced_ms if busy_ms > 0 else None,
          "device_top": top})

    # every backend setting on the north star: median of 10 warm runs
    ns_ms = {tag: wall_ms(lambda: eng_b.search(s1, s2), runs=10)
             for tag, eng_b in ns_engines.items()}
    emit({"phase": "north_star_backends_ms", "runs": 10,
          **{tag: {"median": m, "min": lo, "max": hi}
             for tag, (m, lo, hi) in ns_ms.items()}})

    # long Seq1 end to end: the card path against the native engine, tuple
    # and score bits; its near > k fallbacks from one run of the device half
    s1l, s2l = random_sequences(LONG_SEQ1["n1"], LONG_SEQ1["n2"], seed=LONG_SEQ1["seed"])
    eng_native = ns_engines["native"]
    long_res, long_ms = {}, {}
    for tag, eng_l in (("torch", eng), ("native", eng_native)):
        long_res[tag] = eng_l.search(s1l, s2l)
        long_ms[tag] = wall_ms(lambda: eng_l.search(s1l, s2l), runs=3, warm=0)
    c1l, c2l = encode(s1l), encode(s2l)
    noff_l, _, l2p_l, l1k_l = sw.plan_shapes(c1l.shape[0], c2l.shape[0])
    packed_l, _ = batch.run_exact(sw.upload_codes(c1l, l1k_l, dev),
                                  sw.upload_codes(c2l, l2p_l, dev), noff_l, dtabs)
    near_l = int(batch.unpack_epilogue_outputs(packed_l.cpu().numpy(), batch.TOPK)[2][0])
    lt, ln = long_res["torch"], long_res["native"]
    long_equal = ((lt.offset, lt.char_offset, lt.sub_code) == (ln.offset, ln.char_offset,
                                                               ln.sub_code)
                  and lt.score.hex() == ln.score.hex())
    pe_long = float(noff_l) * LONG_SEQ1["n2"]
    emit({"phase": "long_seq1", "n1": LONG_SEQ1["n1"], "n2": LONG_SEQ1["n2"],
          "torch": [lt.offset, lt.char_offset, lt.sub_code, lt.score],
          "native": [ln.offset, ln.char_offset, ln.sub_code, ln.score],
          "equal_bits": long_equal, "near": near_l, "fallback": near_l > batch.TOPK,
          "torch_ms": long_ms["torch"], "native_ms": long_ms["native"],
          "native_pair_evals_per_s": pe_long / (long_ms["native"][0] * 1e-3)})
    if not long_equal:
        return fail("1M x 2048: the card path and the native engine differ")

    # auto_threshold: the native engine's pair-evals/s (all threads) and the
    # card path's fixed cost per query, from the engine's latency at small
    # shapes; the crossover is where the native engine's time reaches it
    rng_small = np.random.default_rng(5)
    small = []
    for n1, n2 in SMALL_SHAPES:
        c1s, c2s = random_codes(rng_small, n1), random_codes(rng_small, n2)
        t_ms = wall_ms(lambda: eng.search_codes(c1s, c2s), runs=10)
        n_ms = wall_ms(lambda: eng_native.search_codes(c1s, c2s), runs=10)
        small.append({"n1": n1, "n2": n2, "pair_evals": (n1 - n2 + 1) * n2,
                      "torch_ms": t_ms, "native_ms": n_ms})
    rate_ns = ((NORTH_STAR["n1"] - NORTH_STAR["n2"] + 1) * NORTH_STAR["n2"]
               / (ns_ms["native"][0] * 1e-3))
    torch_fixed_ms = statistics.median(row["torch_ms"][0] for row in small[:2])
    native_fixed_ms = small[0]["native_ms"][0]
    derived = (torch_fixed_ms - native_fixed_ms) * 1e-3 * rate_ns
    crossed = [row["pair_evals"] for row in small if row["torch_ms"][0] < row["native_ms"][0]]
    emit({"phase": "auto_threshold", "native_pair_evals_per_s_100kx10k": rate_ns,
          "native_pair_evals_per_s_1Mx2048": pe_long / (long_ms["native"][0] * 1e-3),
          "torch_fixed_ms": torch_fixed_ms, "native_fixed_ms": native_fixed_ms,
          "derived_threshold": derived,
          "first_shape_where_torch_is_faster": crossed[0] if crossed else None,
          "config_threshold": CONFIG.auto_threshold,
          "omp_threads": native.omp_max_threads(), "small_shapes": small})

    # 5b. the batched kernels at the batch workload's shape (B = 1024 of
    # 2048 x 512) at the batch path's padding (noff_pad 1792) and at whole
    # 1024-offset blocks (2048), in turns; their plain versions; then the
    # batch path's phases
    b = BATCH["b"]
    noff_b, _, l2p_b, _ = sw.plan_shapes(BATCH["n1"], BATCH["n2"])
    noff_pad_b, _ = sw.plan_bucket([noff_b], l2p_b)
    wide1 = pad_offsets(torch, big1, 2048, l2p_b)
    inputs = {noff_pad_b: (big1, big1[0].contiguous()),
              2048: (wide1, wide1[0].contiguous())}
    ktimes = {}
    for name, compiled in (("sweep_batched", "sweep_batched_kernel<false>"),
                           ("sweep_batched_shared", "sweep_batched_kernel<true>")):
        fn = sw.sweep_batched if name == "sweep_batched" else sw.sweep_batched_shared
        plain = (sw.sweep_batched_plain if name == "sweep_batched"
                 else sw.sweep_batched_shared_plain)
        rows = {pad: c1 if name == "sweep_batched" else row
                for pad, (c1, row) in inputs.items()}
        runs = {pad: [] for pad in rows}
        for pad in (noff_pad_b, 2048, 2048, noff_pad_b):
            runs[pad].append(kernel_times(torch, lambda: fn(rows[pad], big2, code),
                                          runs=30))
        p_ms, p_q1, p_q3 = cuda_ms(torch, lambda: plain(rows[noff_pad_b], big2, code),
                                   runs=10, warm=1)
        for pad, got in runs.items():
            k_ms = statistics.mean(one[0] for one, _ in got)
            k_bb = statistics.mean(bb[0] for _, bb in got)
            bound_ms, bound_by = batched_bound(
                [noff_b] * b, [BATCH["n2"]] * b,
                rows[pad].numel(), b * l2p_b, pad)
            padded_pairs = float(b) * pad * l2p_b
            if pad == noff_pad_b:
                ktimes[name] = dict(ms=k_ms, ms_back_to_back=k_bb, plain_ms=p_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
            emit({"phase": "batched_sweep_time", "kernel": name, "b": b,
                  "n1": BATCH["n1"], "n2": BATCH["n2"], "noff_pad": pad,
                  "path_padding": pad == noff_pad_b, "kernel_ms": k_ms,
                  "kernel_ms_rounds": [list(one) for one, _ in got],
                  "kernel_ms_back_to_back": k_bb,
                  "back_to_back_rounds": [list(bb) for _, bb in got],
                  "us_per_query": k_ms * 1e3 / b,
                  "pair_evals_per_s": b * noff_b * BATCH["n2"] / (k_ms * 1e-3),
                  "plain_ms": p_ms if pad == noff_pad_b else None,
                  "plain_ms_iqr": [p_q1, p_q3] if pad == noff_pad_b else None,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "padded_pairs": padded_pairs,
                  "dispatch_ms": dispatch_ms(sass, compiled, padded_pairs),
                  "plan": sw.batched_plan(l2p_b, pad, b, name != "sweep_batched"),
                  "runs": 2 * 30, "back_to_back": KERNEL_BACK_TO_BACK,
                  "plain_runs": 10})

    dtabs_b = device_tables(build_tables(np.array(BATCH["weights"]),
                                         BATCH["is_max"]), dev)
    for name, qs in bq.items():
        shared = name == "shared_s1"
        split, res_split, fallbacks = batch_split(torch, batch, alphabet, qs, dtabs_b,
                                                  shared, runs=10)
        if res_split != bres[name]:
            return fail(f"the phased batch run of {name} changed its results")
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            search_batch(qs)
            walls.append((time.perf_counter() - t0) * 1e3)
        traced_ms, busy_ms, top = traced_busy(torch, lambda: search_batch(qs))
        med = statistics.median(walls)
        emit({"phase": "batch_path_ms", "workload": name, "queries": len(qs),
              "split_ms": split, "split_runs": 10, "near_gt_k_fallbacks": fallbacks,
              "host_engine": native.host_engine(),
              "search_batch_ms": med, "min": min(walls), "max": max(walls),
              "runs": len(walls), "queries_per_s": len(qs) / (med * 1e-3),
              "traced_ms": traced_ms,
              "device_busy_ms": busy_ms if busy_ms > 0 else None,
              "device_busy_share": busy_ms / traced_ms if busy_ms > 0 else None,
              "device_top": top})
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        search_batch(wide)
        walls.append((time.perf_counter() - t0) * 1e3)
    traced_ms, busy_ms, top = traced_busy(torch, lambda: search_batch(wide))
    med = statistics.median(walls)
    emit({"phase": "batch_path_ms", "workload": "per_row_8_microbatches",
          "queries": len(wide), "search_batch_ms": med, "min": min(walls),
          "max": max(walls), "runs": len(walls),
          "queries_per_s": len(wide) / (med * 1e-3), "traced_ms": traced_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else None,
          "device_busy_share": busy_ms / traced_ms if busy_ms > 0 else None,
          "device_top": top})

    # 5c. the lab's sweeps at the lab's shape and the north star: kernel,
    # plain version and the bound of their route
    lab_times = {}
    for name, n1, n2 in (("bench", LAB["n1"], LAB["n2"]),
                         ("north_star", 100_000, 10_000)):
        noff, noff_pad, l2p, l1k = v2.plan_shapes_v2(n1, n2)
        d1 = sw.upload_codes(random_codes(rng, n1), l1k, dev)
        d2 = sw.upload_codes(random_codes(rng, n2), l2p, dev)
        for kernel, mod, fn, plain, compiled in (
                ("sweep_v2", v2, v2.sweep_v2, v2.sweep_v2_plain,
                 "sweep_mma_kernel"),
                ("sweep_v3", v3, v3.sweep_v3, v3.sweep_v3_plain,
                 "sweep_v3_kernel")):
            (k_ms, k_q1, k_q3), (k_bb, bb_q1, bb_q3) = kernel_times(
                torch, lambda: fn(d1, d2, code), runs=20)
            p_ms, p_q1, p_q3 = cuda_ms(torch, lambda: plain(d1, d2, code),
                                       runs=5, warm=1)
            bound_ms, bound_by, terms = lab_bound(mod, noff, n2, l1k, l2p, noff_pad)
            lab_times[kernel, name] = dict(ms=k_ms, ms_back_to_back=k_bb, plain_ms=p_ms,
                                           bound_ms=bound_ms, bound_by=bound_by)
            emit({"phase": "lab_sweep_time", "kernel": kernel, "case": name,
                  "n1": n1, "n2": n2, "kernel_ms": k_ms, "kernel_ms_iqr": [k_q1, k_q3],
                  "kernel_ms_back_to_back": k_bb, "back_to_back_iqr": [bb_q1, bb_q3],
                  "pair_evals_per_s": float(noff) * n2 / (k_ms * 1e-3),
                  "plain_ms": p_ms, "plain_ms_iqr": [p_q1, p_q3],
                  "bound_ms": bound_ms, "bound_by": bound_by, "bound_terms_ms": terms,
                  "dispatch_ms": dispatch_ms(sass, compiled, float(noff) * n2),
                  "plan": lab_plan(v2, v3, kernel, noff_pad, l2p),
                  "v1_ms_this_run": timings[name]["ms"], "runs": 20,
                  "back_to_back": KERNEL_BACK_TO_BACK, "plain_runs": 5})

    # 6. the ported kernels
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    shape_b = f"{b}x{BATCH['n1']}x{BATCH['n2']} (noff_pad {noff_pad_b})"
    emit({"kernels": [
        {"name": "sweep", "route": "cuda", "source": "psa_torch/csrc/sweep.cu",
         "replaces": "psa_tpu/ops/pallas_sweep.py:297",
         "launches": single_launches["sweep"], "max_abs_err": max_abs,
         "max_abs_diff": max_abs, "shape": "100000x10000",
         **timings["north_star"], "library_ms": None},
        {"name": "sweep_batched", "route": "cuda",
         "source": "psa_torch/csrc/sweep_batched.cu",
         "replaces": "psa_tpu/ops/pallas_sweep.py:365",
         "launches": batch_launches["sweep_batched"],
         "max_abs_err": batched_abs["sweep_batched"],
         "max_abs_diff": batched_abs["sweep_batched"], "shape": shape_b,
         **ktimes["sweep_batched"], "library_ms": None},
        {"name": "sweep_batched_shared", "route": "cuda",
         "source": "psa_torch/csrc/sweep_batched.cu",
         "replaces": "psa_tpu/ops/pallas_sweep.py:492",
         "launches": batch_launches["sweep_batched_shared"],
         "max_abs_err": batched_abs["sweep_batched_shared"],
         "max_abs_diff": batched_abs["sweep_batched_shared"], "shape": shape_b,
         **ktimes["sweep_batched_shared"], "library_ms": None},
        *({"name": kernel, "route": "cuda", "source": source,
           "replaces": replaces, "launches": lab_launches[kernel],
           "max_abs_err": lab_abs[kernel], "max_abs_diff": lab_abs[kernel],
           "shape": f"{LAB['n1']}x{LAB['n2']}", **lab_times[kernel, "bench"],
           "library_ms": None}
          for kernel, source, replaces in (
              ("sweep_v2", "psa_torch/csrc/sweep_mma.cu", "psa_tpu/ops/_sweep_v2.py:86"),
              ("sweep_v3", "psa_torch/csrc/sweep_mma_v3.cu",
               "psa_tpu/ops/_sweep_v3.py:101")))]})
    # 7. last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
