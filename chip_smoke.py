#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (psa_torch) on one GPU.

    python3 chip_smoke.py [--against TREE]

With --against TREE (a directory holding another commit's psa_torch) the
`sweep_ab` phase times that tree's offset sweeps and this checkout's in
turns on the same card (psa_torch/utils/sweep_ab.py); without it, this
checkout's alone.

Builds the sweep kernels and the top-k epilogue kernel from psa_torch/csrc
and holds each against its plain PyTorch version on the card (the epilogue
word for word at every shape the paths give it, in one CUDA launch a call,
and a warm north-star query's device events counted in a new process) (`sweep` also at the edges of its even
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
- the serve warm start (`--serve --listen --warmup FILE`, a file of the
  batch workload's lines on one shared Seq1): new servers with and without
  the warmup, each timed from its spawn to its listening line and through
  its first request (1 line or 256), a first 256 on one Seq1 and steady
  256-line requests, every reply held against the native engine's and
  every `[warmup]` line before the listening line; then the warmup in this
  process with its launches counted, and a first chunk of each kind that
  must allocate no device segment;
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
# The least work per (offset, position) pair on the table route (the
# sweeps' pair loop before the bit-sliced one): one shared-memory table read
# and two integer ops (one address add, and half an IADD3 and half a
# VIMNMX3: it accumulates and maxes two positions per instruction).  At
# these rates the table reads bound that route.
INT_OPS_PER_PAIR = 2
# The bit-sliced route of csrc/sweep.cu and csrc/sweep_batched.cu
# (csrc/sweep_core.cuh): a warp covers 1024 offsets (a 32-bit word a lane)
# at each Seq2 position.  Per position and warp it makes eight 32-bit
# shared loads, one wavefront each (two columns of each of four kinds), and
# BITSLICED_ALU_OPS warp instructions on the INT32 lanes: four funnel
# shifts, an AND, an OR, the carry-save adders (31 of two LOP3s a kind per
# 32 positions, four kinds), the carry of 32 into six planes (two a plane a
# kind per 32 positions), a PRMT and a LEA for the address (556 of the
# main loop's 855 instructions per 32 positions in the SASS of an sm_90a
# build).  So a pair costs 8 / 1024 of a wavefront (32 lanes per SM per
# clock serve one) and 32 x 17.4 / 1024 INT32 lane ops.
BITSLICED_LOADS_PER_POS = 8
BITSLICED_ALU_OPS = 556 / 32
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
# epilogue calls per case in the profile of `epilogue_launches_child`
EPILOGUE_PROFILE_CALLS = 20


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


def bitsliced_bound(pairs: float, in_bytes: int, out_bytes: int):
    """(bound_ms, bound_by) of a sweep on the bit-sliced route: the bytes
    of each input read once and of the output written once over HBM,
    against the real pairs over the shared-memory wavefronts
    (BITSLICED_LOADS_PER_POS a warp's 1024 pairs) and the INT32 lanes
    (BITSLICED_ALU_OPS warp instructions a warp's 1024 pairs)."""
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(pairs / 1024 * BITSLICED_ALU_OPS * 32 / INT32_OPS_PER_S,
                 pairs / 1024 * BITSLICED_LOADS_PER_POS * 32 / SMEM_LOADS_PER_S) * 1e3
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
    from psa_torch.ops import epilogue as ep

    sw.launches = sw.launches_batched = sw.launches_batched_shared = 0
    v2.launches_v2 = v3.launches_v3 = ep.launches = ep.cuda_launches = 0


def read_launches(sw, v2, v3) -> dict:
    from psa_torch.ops import epilogue as ep

    return {"sweep": sw.launches, "sweep_batched": sw.launches_batched,
            "sweep_batched_shared": sw.launches_batched_shared,
            "sweep_v2": v2.launches_v2, "sweep_v3": v3.launches_v3,
            "epilogue": ep.launches, "epilogue_cuda_launches": ep.cuda_launches}


def sweep_launches(launches: dict) -> int:
    """Launches of the sweep kernels in a `read_launches` dict."""
    return sum(n for name, n in launches.items() if name.startswith("sweep"))


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
    the batch workload's shape and at the split's edges; the shared
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
    slots = sw.batched_plan(1120, sw.TILE_O, 1, False)["blocks_per_sm"] * sms
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
            ("seq2_segments", slots + 5, 2123, 1100, 0.0, 0.0, False, True),
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
        if (case in ("seq2_segments", "seq2_split")
                and not (p["units"] > p["items"] and p["split_items"] > 0)):
            raise AssertionError(f"{case} did not take the split it is for")
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


# The batch cells' launch: B = 4 queries of 600,000 x 250,000, each its own
# Seq1 (`batch.long_rows`) or all on one (`batch.long_shared`).
CELL = dict(b=4, n1=600_000, n2=250_000)


def batched_cell_phase(torch, sw, code, dev):
    """Both batched kernels at the batch cells' launch: the per-row kernel
    against B `sweep` launches bit for bit and the shared one against the
    per-row kernel on broadcast rows; each kernel's plan, its ms (one
    launch per pair of CUDA events) beside the B `sweep` launches' ms on
    the same rows, and its table-read bound.  Returns the phase's line or
    raises."""
    from psa_torch.utils.kernel_lab import cuda_ms

    b, n1, n2 = CELL["b"], CELL["n1"], CELL["n2"]
    rng = np.random.default_rng(22)
    noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
    c1b = np.full((b, l1k), 28, np.uint8)
    c2b = np.full((b, l2p), 28, np.uint8)
    for q in range(b):
        c1b[q, :n1] = random_codes(rng, n1, 0.05, 0.05)
        c2b[q, :n2] = random_codes(rng, n2, 0.05, 0.05)
    d1 = torch.from_numpy(c1b).to(dev)
    d2 = torch.from_numpy(c2b).to(dev)
    rows1 = [d1[q].contiguous() for q in range(b)]
    rows2 = [d2[q].contiguous() for q in range(b)]
    wide = d1[:1].expand(b, -1).contiguous()
    got = sw.sweep_batched(d1, d2, code)
    if not torch.equal(got, torch.stack([sw.sweep(rows1[q], rows2[q], code)
                                         for q in range(b)])):
        raise AssertionError("sweep_batched disagrees with sweep at the batch cells' shape")
    if not torch.equal(sw.sweep_batched_shared(rows1[0], d2, code),
                       sw.sweep_batched(wide, d2, code)):
        raise AssertionError("sweep_batched_shared disagrees with sweep_batched "
                             "on broadcast rows at the batch cells' shape")
    sweeps_ms = cuda_ms(torch, lambda: [sw.sweep(rows1[q], rows2[q], code)
                                        for q in range(b)], runs=10)
    bound_ms, bound_by = batched_bound([noff] * b, [n2] * b, d1.numel(), d2.numel(),
                                       noff_pad)
    route_ms, route_by = bitsliced_bound(float(noff) * n2 * b, d1.numel() + d2.numel(),
                                         5 * 4 * noff_pad * b)
    line = {"phase": "batched_cell", "b": b, "n1": n1, "n2": n2,
            "sweeps_ms": list(sweeps_ms), "bound_ms": bound_ms, "bound_by": bound_by,
            "bitsliced_bound_ms": route_ms, "bitsliced_bound_by": route_by,
            "runs": 10}
    for name, fn in (("sweep_batched", lambda: sw.sweep_batched(d1, d2, code)),
                     ("sweep_batched_shared",
                      lambda: sw.sweep_batched_shared(rows1[0], d2, code))):
        plan = sw.batched_plan(l2p, noff_pad, b, name != "sweep_batched")
        ms = cuda_ms(torch, fn, runs=10)
        line[name] = {"plan": plan, "ms": list(ms), "over_sweeps": ms[0] / sweeps_ms[0],
                      "of_bound": bound_ms / ms[0], "of_bitsliced_bound": route_ms / ms[0],
                      "balance": plan["units"] / (plan["workers"] * plan["per_worker"])}
    emit(line)
    return line


def sweep_ab_phase() -> dict:
    """`psa_torch.utils.sweep_ab` in a process of its own: `sweep` and both
    batched kernels at 600,000 x 250,000 (B = 1, 4, 8) and at the batch
    workload's small shape, ms a launch; with `--against TREE` on the
    command line, TREE's sweeps and this checkout's in turns (TREE, this,
    this, TREE), else this checkout's alone.  Emits the summary line."""
    trees = ["."]
    if "--against" in sys.argv:
        other = sys.argv[sys.argv.index("--against") + 1]
        trees = [other, ".", ".", other]
    proc = subprocess.run([sys.executable, "-m", "psa_torch.utils.sweep_ab", *trees],
                          cwd=ROOT, capture_output=True, text=True, timeout=1800)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    line = dict(lines[-1] if lines else {}, phase="sweep_ab", trees=trees,
                rc=proc.returncode, runs_lines=lines[:-1])
    emit(line)
    return line


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
        d1, d2 = sw.upload_codes(dev, (c1, l1k), (c2, l2p))
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
    # all 'A' in the maximum mode meets no top rank: every step sweeps the
    # lower thresholds too, which the counters show
    from psa_torch.core.tables import build_tables

    code_max = torch.from_numpy(build_tables(np.array(NORTH_STAR["weights"]),
                                             True).code).to(dev)
    noff, noff_pad, l2p, l1k = sw.plan_shapes(200_000, 2048)
    d1, d2 = sw.upload_codes(dev, (np.zeros(200_000, np.int32), l1k),
                             (np.zeros(2048, np.int32), l2p))
    counters = sw.rank_counters(dev)
    got = sw.sweep(d1, d2, code_max, counters)
    torch.cuda.synchronize()
    diff = int((got.long() - sw.sweep_plain(d1, d2, code_max).long()).abs().max().item())
    passes, steps = counters.tolist()
    emit({"phase": "kernel_vs_plain", "case": "all_A_maximum", "n1": 200_000, "n2": 2048,
          "noff_pad": noff_pad, "l2p": l2p, "max_abs_diff": diff, "tolerance": 0,
          "rank_passes_pm": sw.rank_passes_pm((passes, steps))})
    if diff != 0 or passes <= steps:
        raise AssertionError("sweep at all 'A' (maximum) disagrees with its plain "
                             "version or took no lower threshold pass")
    max_abs = max(max_abs, diff)
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
        d1, d2 = sw.upload_codes(dev, (c1, l1k), (c2, l2p))
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
    synchronise after each: host prep (the checked encode), upload, device
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
        _, _, l2p, _ = batch.plan_shapes(len(queries[0].seq1), len(queries[0].seq2))
        noffs = np.array([len(q.seq1) - len(q.seq2) + 1 for q in queries], np.int32)
        _, l1k = batch.plan_bucket(noffs, l2p)
        c1b, ok1 = alphabet.encode_batch_checked([q.seq1 for q in queries], l1k)
        c2b, ok2 = alphabet.encode_batch_checked([q.seq2 for q in queries], l2p)
        assert (ok1 & ok2).all()
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

def epilogue_bound(rows: int, np_len: int, k: int):
    """(bound_ms, "bytes") of one epilogue call: its stats5 read once (20
    bytes an offset) and its pack written once (4 (6k + 2) bytes a row)
    over HBM; its f32 operations (~10 an offset) take ~100x less at the
    fp32 peak."""
    return rows * (20 * np_len + 4 * (6 * k + 2)) / HBM_BYTES_PER_S * 1e3, "bytes"


def kth_tie_rows(torch, stats5, dtabs, noff, k: int) -> int:
    """Rows of stats5 whose k-th and (k+1)-th largest keys are equal (where
    only the tie order, lowest offset first, fixes the pack)."""
    from psa_torch.ops.common import keyed_f32_totals_ops

    keyed, _ = keyed_f32_totals_ops(stats5[:, :4], stats5[:, 4], dtabs.w32,
                                    dtabs.diff32, dtabs.is_max, noff)
    if keyed.shape[-1] <= k:
        return 0
    top = torch.topk(keyed, k + 1, dim=-1).values
    return int((top[:, k - 1] == top[:, k]).sum().item())


def epilogue_kernel_phase(torch, sw, ep, mesh_mod, dev, encode, random_sequences,
                          build_tables, device_tables, big):
    """csrc/epilogue.cu against its plain version on the same card tensors,
    word for word (`torch.equal`; `pack_mismatch` names the first
    difference) in exactly one CUDA launch a call, on the stats5 of every
    shape the paths give it: the north star in both modes, the batch
    workload's 1024 rows (per-row and shared Seq1, per-row noff; noff < k;
    rows with no valid offset), 1M x 2,048, 600k x 250k, all-'A' 200,000 x
    2,048 (near > k), exact ties of 1 3 4 2 at the k-th key (both repeated:
    three calls, one pack), and the shards of a 4-shard north star, 1-D and
    2 x 2 (captured from `search_sharded` and `search_sharded_2d`).  The
    north star, the batch, 1M and all-'A' are timed beside the plain version
    and the launch floor, with the wrapper's host µs.  Returns ({case:
    times}, the largest difference in near or best) or raises
    AssertionError."""
    from psa_torch.utils.epilogue_ab import host_us
    from psa_torch.utils.kernel_lab import cuda_ms

    k = ep.TOPK
    lib = sw.build_library()
    assert (lib.psa_epilogue_cols(), lib.psa_epilogue_narrow_cols(),
            lib.psa_epilogue_params()) == (ep.EPILOGUE_COLS, ep.NARROW_COLS, ep.PARAMS), \
        "csrc/epilogue.cu kRowCols, kNarrowCols, kParams"
    w = NORTH_STAR["weights"]
    tabs = {m: device_tables(build_tables(np.array(w), m), dev) for m in (False, True)}
    rng = np.random.default_rng(14)

    def stats_of(n1, n2, seed=None, c1=None, c2=None, is_max=False):
        if c1 is None:
            a, b = random_sequences(n1, n2, seed=seed)
            c1, c2 = encode(a), encode(b)
        noff, _, l2p, l1k = sw.plan_shapes(c1.shape[0], c2.shape[0])
        d1, d2 = sw.upload_codes(dev, (c1, l1k), (c2, l2p))
        return sw.sweep(d1, d2, tabs[is_max].code)[None], noff, l2p

    def check(case, stats5, dtabs, noff, l2p, g0=0, repeats=1):
        before = ep.cuda_launches
        got = ep.epilogue_pack(stats5, dtabs, noff, l2p, g0=g0)
        launched = ep.cuda_launches - before
        again = [ep.epilogue_pack(stats5, dtabs, noff, l2p, g0=g0) for _ in range(repeats - 1)]
        want = ep.epilogue_pack_plain(stats5, dtabs, noff, l2p, g0=g0)
        torch.cuda.synchronize()
        diff = ep.pack_mismatch(want, got, stats5, noff, dtabs, g0)
        if diff is None and not torch.equal(got, want):
            diff = "pack_mismatch found no difference, torch.equal one"
        if diff is None and not all(torch.equal(p, got) for p in again):
            diff = f"another pack in {repeats} calls"
        out, ref = got.cpu().numpy(), want.cpu().numpy()
        near = out[:, 6 * k]
        best = out[:, 6 * k + 1].view(np.float32)
        with np.errstate(invalid="ignore"):
            gap = np.abs(best - ref[:, 6 * k + 1].view(np.float32))
        err = max(float(np.abs(near - ref[:, 6 * k]).max()),
                  float(np.nan_to_num(gap, nan=0.0).max()))
        worst[0] = max(worst[0], err)
        rows, np_len = stats5.shape[0], stats5.shape[2]
        line = {"phase": "epilogue_kernel", "case": case, "rows": rows, "np": np_len,
                "is_max": dtabs.is_max, "g0": g0,
                "cuda_launches_per_call": launched, "equal_calls": repeats,
                "near_max": int(near.max()), "near_gt_k_rows": int((near > k).sum()),
                "no_mutation_rows": int(np.isneginf(best).sum()),
                "kth_tie_rows": kth_tie_rows(torch, stats5, dtabs, noff, k),
                "max_abs_diff_near_best": err, "mismatch": diff}
        emit(line)
        if diff is not None:
            raise AssertionError(f"epilogue kernel at {case}: {diff}")
        if launched != 1:
            raise AssertionError(f"epilogue kernel at {case}: {launched} CUDA launches")
        return line

    times, worst = {}, [0.0]

    def timed(case, stats5, dtabs, noff, l2p):
        (k_ms, k_q1, k_q3), (k_bb, bb_q1, bb_q3) = kernel_times(
            torch, lambda: ep.epilogue_pack(stats5, dtabs, noff, l2p), runs=30)
        wrapper_us = host_us(torch, lambda: ep.epilogue_pack(stats5, dtabs, noff, l2p))
        p_ms, p_q1, p_q3 = cuda_ms(torch, lambda: ep.epilogue_pack_plain(
            stats5, dtabs, noff, l2p), runs=10, warm=1)
        bound_ms, bound_by = epilogue_bound(stats5.shape[0], stats5.shape[2], k)
        times[case] = dict(ms=k_ms, ms_back_to_back=k_bb, host_us=wrapper_us,
                           plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "epilogue_time", "case": case, "rows": stats5.shape[0],
              "np": stats5.shape[2], "kernel_ms": k_ms, "kernel_ms_iqr": [k_q1, k_q3],
              "kernel_ms_back_to_back": k_bb, "back_to_back_iqr": [bb_q1, bb_q3],
              "wrapper_host_us": wrapper_us, "launch_floor": floor,
              "plain_ms": p_ms, "plain_ms_iqr": [p_q1, p_q3], "bound_ms": bound_ms,
              "bound_by": bound_by, "runs": 30, "back_to_back": KERNEL_BACK_TO_BACK,
              "plain_runs": 10})

    t0 = time.perf_counter()
    for m in (True, False):
        ns, noff_ns, l2p_ns = stats_of(NORTH_STAR["n1"], NORTH_STAR["n2"],
                                       seed=NORTH_STAR["seed"], is_max=m)
        check(f"north_star_{'max' if m else 'min'}", ns, tabs[m], noff_ns, l2p_ns)
    d1, d2 = big
    b, l2p_b = d2.shape
    noff_b = BATCH["n1"] - BATCH["n2"] + 1
    per_row = torch.full((b,), noff_b, dtype=torch.int32, device=dev)
    rows = sw.sweep_batched(d1, d2, tabs[False].code)
    check("batch_per_row", rows, tabs[False], per_row, l2p_b)
    check("batch_shared_s1", sw.sweep_batched_shared(d1[0].contiguous(), d2,
                                                     tabs[False].code),
          tabs[False], per_row, l2p_b)
    small = torch.from_numpy(rng.integers(1, k, b).astype(np.int32)).to(dev)
    check("batch_noff_lt_k", rows, tabs[False], small, l2p_b)
    none = per_row.clone()
    none[::7] = 0
    line = check("batch_rows_without_offsets", rows, tabs[False], none, l2p_b)
    assert line["no_mutation_rows"] == len(range(0, b, 7)), line
    for case, n1, n2, seed in (("seq1_1M", *LONG_SEQ1.values()),
                               ("seq2_250k", LONG_SEQ2["n1"], LONG_SEQ2["n2"],
                                LONG_SEQ2["seed"])):
        st, noff, l2p = stats_of(n1, n2, seed=seed)
        check(case, st, tabs[False], noff, l2p)
    st, noff, l2p = stats_of(0, 0, c1=np.zeros(TIES["n1"], np.int32),
                             c2=np.zeros(TIES["n2"], np.int32))
    all_a = (st, noff, l2p)
    line = check("all_A_ties", st, tabs[False], noff, l2p, repeats=3)
    assert line["near_gt_k_rows"] == 1, line
    ties = torch.from_numpy(np.concatenate(
        [rng.integers(0, 3, (1, 4, 90_112)),
         rng.integers(-1, tabs[False].tables.num_ranks, (1, 1, 90_112))],
        axis=1).astype(np.int32)).to(dev)
    line = check("integer_weight_ties", ties, tabs[False], 90_000, l2p_ns, repeats=3)
    assert line["kth_tie_rows"] == 1, line
    captured = []
    real = mesh_mod.epilogue_pack

    def record(stats5, dtabs, noff, l2p, k=k, g0=0):
        captured.append((stats5, dtabs, noff, l2p, g0))
        return real(stats5, dtabs, noff, l2p, k, g0)

    s1, s2 = random_sequences(NORTH_STAR["n1"], NORTH_STAR["n2"], seed=NORTH_STAR["seed"])
    c1, c2 = encode(s1), encode(s2)
    mesh_mod.epilogue_pack = record
    try:
        for kind, fn in (("1d", lambda: mesh_mod.search_sharded(
                              c1, c2, tabs[False].tables, [dev] * 4)),
                         ("2x2", lambda: mesh_mod.search_sharded_2d(
                              c1, c2, tabs[False].tables,
                              mesh_mod.make_mesh_2d([dev] * 4, 2, 2)))):
            del captured[:]
            assert winner(fn()) == NORTH_STAR_WINNER, f"4-shard {kind} north star"
            assert len(captured) == 4, f"4-shard {kind}: {len(captured)} epilogues"
            for i, (st, dtabs, noff, l2p, g0) in enumerate(captured):
                check(f"shard_{kind}_{i}", st, dtabs, noff, l2p, g0)
    finally:
        mesh_mod.epilogue_pack = real
    checks_s = time.perf_counter() - t0
    # the launch floor: a one-element fill_ on the same stream, timed alike
    one = torch.zeros(1, device=dev)
    (f_ms, _, _), (f_bb, _, _) = kernel_times(torch, lambda: one.fill_(1.0), runs=30)
    floor = {"ms": f_ms, "ms_back_to_back": f_bb,
             "host_us": host_us(torch, lambda: one.fill_(1.0))}
    timed("north_star", ns, tabs[False], noff_ns, l2p_ns)
    timed("batch_per_row", rows, tabs[False], per_row, l2p_b)
    st, noff, l2p = stats_of(*LONG_SEQ1.values())
    timed("seq1_1M", st, tabs[False], noff, l2p)
    st, noff, l2p = all_a
    timed("all_A", st, tabs[False], noff, l2p)
    times["launch_floor"] = floor
    emit({"phase": "epilogue_kernel_summary", "cases_equal": True, "check_seconds": checks_s,
          "max_abs_diff_near_best": worst[0], "seconds": time.perf_counter() - t0})
    return times, worst[0]


def epilogue_launches_child() -> int:
    """Body of the `epilogue_launch_count` child process: one warm
    north-star query through the engine, then one more under the profiler,
    the plain epilogue on the query's stats5, and the kernel
    EPILOGUE_PROFILE_CALLS times on each of `epilogue_ab.CASES` (north
    star, batch, 1M, all-'A') in the same profile; prints the device events
    (kernels, copies, memsets) of the query and the plain epilogue, by
    name, the epilogue kernel's device µs per call at each case, and the
    wrapper's count of the query's CUDA launches, as one JSON line (ranges
    apart by `epilogue_ab.RANGE_GAP_S` of idle, each event in the nearest).
    A new process, since the smoke's own loses the ctypes kernels' events
    (PERF.md §7)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from psa_torch.core.alphabet import encode
    from psa_torch.models.search import AlignmentSearchEngine
    from psa_torch.ops import epilogue as ep
    from psa_torch.ops import sweep as sw
    from psa_torch.utils import epilogue_ab
    from psa_torch.utils.generator import random_sequences

    s1, s2 = random_sequences(NORTH_STAR["n1"], NORTH_STAR["n2"], seed=NORTH_STAR["seed"])
    eng = AlignmentSearchEngine(NORTH_STAR["weights"], NORTH_STAR["is_max"])
    for _ in range(3):
        eng.search(s1, s2)
    c1, c2 = encode(s1), encode(s2)
    noff, _, l2p, l1k = sw.plan_shapes(c1.shape[0], c2.shape[0])
    dtabs = eng._device_tables()
    d1, d2 = sw.upload_codes("cuda", (c1, l1k), (c2, l2p))
    stats5 = sw.sweep(d1, d2, dtabs.code)[None]
    cases = {case: epilogue_ab.case_stats(torch, sw, dtabs.code, case, torch.device("cuda"))
             for case in epilogue_ab.CASES}
    for st, nf, lp in cases.values():
        ep.epilogue_pack(st, dtabs, nf, lp)
    ep.epilogue_pack_plain(stats5, dtabs, noff, l2p)
    torch.cuda.synchronize()
    ep.cuda_launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("query"):
            got = eng.search(s1, s2)
            torch.cuda.synchronize()
        counted = ep.cuda_launches
        time.sleep(epilogue_ab.RANGE_GAP_S)
        with record_function("plain_epilogue"):
            ep.epilogue_pack_plain(stats5, dtabs, noff, l2p)
            torch.cuda.synchronize()
        for case, (st, nf, lp) in cases.items():
            time.sleep(epilogue_ab.RANGE_GAP_S)
            with record_function(case):
                for _ in range(EPILOGUE_PROFILE_CALLS):
                    ep.epilogue_pack(st, dtabs, nf, lp)
                torch.cuda.synchronize()
    events = epilogue_ab.device_events(prof, ["query", "plain_epilogue", *cases])
    out = {name: {k: v[0] for k, v in events[name].items()}
           for name in ("query", "plain_epilogue")}
    device_us = {case: sum(v[1] for name, v in events[case].items() if "epilogue" in name)
                 / EPILOGUE_PROFILE_CALLS for case in cases}
    print(json.dumps({"winner": [got.offset, got.char_offset, got.sub_code, got.score],
                      "counted_cuda_launches": counted, "device_us": device_us, **out}),
          flush=True)
    return 0


def epilogue_launch_count() -> dict:
    """The device events of one warm north-star query and of the plain
    epilogue, and the kernel's device µs per call at four shapes, from
    `epilogue_launches_child` in a new process; checks that the query
    enqueued one epilogue kernel, as many as the wrapper counted, one
    host-to-device copy and 8 device events in all: the upload, the sweep's
    two memsets, the sweep, the epilogue, the fetch, and the zeroing and the
    copy of the sweep's rank counters, which the span recorder (on from
    import) reads (no memset beside the sweep's)."""
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.epilogue_launches_child())"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, f"epilogue_launch_count: rc {p.returncode}: {p.stderr[-2000:]}"
    got = json.loads(p.stdout.strip().splitlines()[-1])
    query = got.get("query", {})
    count = {"epilogue_kernels": sum(n for name, n in query.items()
                                     if name.startswith("kernel") and "epilogue_" in name),
             "h2d_copies": sum(n for name, n in query.items() if "HtoD" in name),
             "memsets": sum(n for name, n in query.items() if name.startswith("gpu_memset")),
             "device_events": sum(query.values()),
             "plain_epilogue_events": sum(got.get("plain_epilogue", {}).values())}
    line = {"phase": "epilogue_launch_count", **count, "device_us": got["device_us"],
            "events": got}
    emit(line)
    assert tuple(got["winner"]) == NORTH_STAR_WINNER, f"traced query: {got['winner']}"
    assert count["epilogue_kernels"] == 1, f"epilogue kernels per query: {count}"
    assert count["epilogue_kernels"] == got["counted_cuda_launches"], \
        f"the profiler saw {count['epilogue_kernels']} epilogue kernels, the wrapper " \
        f"counted {got['counted_cuda_launches']}"
    assert count["h2d_copies"] == 1, f"host-to-device copies per query: {count}"
    assert count["device_events"] == 8, f"device events per query: {count}"
    assert all(us > 0 for us in got["device_us"].values()), \
        f"the profiler saw no epilogue kernel: {got['device_us']}"
    return line


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
        t0 = time.perf_counter()
        self.proc = subprocess.Popen([*SERVE_CMD, *args], cwd=ROOT, env=env,
                                     stdin=stdin, stdout=stdout,
                                     stderr=subprocess.PIPE, text=True)
        self.err: list = []
        self.port = None
        # with --listen: the stderr lines before the listening line (the
        # warmup's), and the seconds from the spawn to that line
        self.before: list = []
        self.listen_s = None
        if "--listen" in args:
            for line in self.proc.stderr:
                if "listening on" in line:
                    self.listen_s = time.perf_counter() - t0
                    self.port = int(line.rsplit(":", 1)[1])
                    break
                self.before.append(line.rstrip("\n"))
            else:
                self.proc.kill()
                raise AssertionError(f"serve --listen did not start: {self.before[-5:]}")
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


def two_physical_cores():
    """Two CPUs of this process's affinity set on different physical cores
    (by /sys's package and core ids), or None where there is no such pair."""
    cpus = sorted(os.sched_getaffinity(0))

    def core(c):
        topo = Path(f"/sys/devices/system/cpu/cpu{c}/topology")
        try:
            return ((topo / "physical_package_id").read_text().strip(),
                    (topo / "core_id").read_text().strip())
        except OSError:
            return ("?", str(c))

    for c in cpus[1:]:
        if core(c) != core(cpus[0]):
            return cpus[0], c
    return None


def event_wait_gil(torch, dev, n: int = 4096, reps: int = 40):
    """Iterations per ms of a pure-Python loop on this thread while another
    thread waits in `torch.cuda.Event.synchronize` (as the serve loops'
    Finisher does in `Fetch.wait`), against the same loop while another
    thread sleeps as long (which releases the GIL).  A wait that held the
    GIL would leave the loop at ~0.  The wait spins on its CPU, so the two
    threads are pinned to different physical cores: on two hyperthreads of
    one core the spin alone would halve the loop."""
    a = torch.randn(n, n, device=dev)
    a @ a
    torch.cuda.synchronize()
    pair = two_physical_cores()
    own = os.sched_getaffinity(0)

    def pinned(cpu, fn, *args):
        def run():
            if cpu is not None:
                os.sched_setaffinity(0, {cpu})      # this thread only
            fn(*args)
        return run

    def spin(thread):
        k = 0
        thread.start()
        while thread.is_alive():
            k += 1
        return k

    if pair is not None:
        os.sched_setaffinity(0, {pair[0]})
    try:
        ev = torch.cuda.Event()
        for _ in range(reps):
            a @ a
        ev.record()
        other = pair[1] if pair is not None else None
        t0 = time.perf_counter()
        busy = spin(threading.Thread(target=pinned(other, ev.synchronize)))
        wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        asleep = spin(threading.Thread(target=pinned(other, time.sleep, wait_s)))
        sleep_s = time.perf_counter() - t0
    finally:
        os.sched_setaffinity(0, own)
    return {"wait_ms": wait_s * 1e3, "iters_per_ms_while_waiting": busy / (wait_s * 1e3),
            "iters_per_ms_while_sleeping": asleep / (sleep_s * 1e3),
            "ratio": (busy / wait_s) / (asleep / sleep_s), "cpus": list(pair or [])}


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
        batched = wv["sweep_batched"] + wv["sweep_batched_shared"]
        assert wv["epilogue"] == batched, \
            f"serve_kernels {name}: {wv['epilogue']} epilogues for {batched} batched launches"
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


# The serve warm start (`--serve --warmup FILE`): the warmup file holds the
# batch workload's first lines on one shared Seq1 (one bucket whose lines
# share Seq1, so both batched kernels warm); the servers run at
# --serve-batch 256 on the build already cached.
WARMUP = dict(batch=256, file_lines=8, steady=5)


def serve_requests(sp, requests):
    """Each (name, lines, want) as one TCP connection after the previous one
    is answered; a one-line request is timed as a closed loop.  Returns
    {name: (client ms, the chunks (queries, ms) the server logged for it)}
    and the mismatched replies."""
    out, n_bad = {}, 0
    for name, lines, want in requests:
        n_log = len(sp.chunk_log())
        replies, lat, secs = tcp_clients(("127.0.0.1", sp.port), [lines], len(lines) == 1)
        n_bad += mismatches(replies, [want])
        t_end = time.perf_counter() + 10      # the log line may trail the reply
        while (sum(n for n, _ in sp.chunk_log()[n_log:]) < len(lines)
               and time.perf_counter() < t_end):
            time.sleep(0.01)
        out[name] = (lat[0] if lat else secs * 1e3, sp.chunk_log()[n_log:])
    return out, n_bad


def serve_warmup_split_child(warm_file: str) -> int:
    """In a new process: the CLI's warmup of `warm_file` with the serve
    loop's finishing thread (utils/server.Finisher), then four 256-line
    chunks of the batch workload (seeds 0..1023), each split into parse,
    dispatch (buckets, encode, uploads, launches), the hand-off to the
    finishing thread, the fetch wait, host selection and formatting.  The
    first two chunks finish on the warmup's finishing thread, as a warmed
    server's do; the third on a new thread after one tiny native call with
    an OpenMP parallel region there (`team_ms`); the fourth on another new
    thread.  Prints one JSON line."""
    import queue

    import torch

    from psa_torch import native
    from psa_torch.models import batch
    from psa_torch.utils import cli as cli_mod
    from psa_torch.utils.generator import random_sequences
    from psa_torch.utils.io import Query, parse_query_lines
    from psa_torch.utils.server import Finisher

    dev = torch.device("cuda")
    n = WARMUP["batch"]
    args = cli_mod.build_parser().parse_args(
        ["--serve", "--quiet", "--serve-batch", str(n), "--warmup", warm_file])
    cli_mod._fold_device_share(args)
    fin = Finisher()
    t0 = time.perf_counter()
    rc = cli_mod._serve_warmup(args, dev, None, fin)
    warm_s = time.perf_counter() - t0
    queries = batch_queries(Query, random_sequences, shared=False, b=4 * n)

    def new_thread():
        jobs: queue.Queue = queue.Queue()
        done: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [done.put(fn()) for fn in iter(jobs.get, None)],
                         daemon=True).start()
        return lambda fn: (jobs.put(fn), done.get())[1]

    def chunk(qs, run_on):
        lines = [serve_line(q) for q in qs]
        t = [time.perf_counter()]
        ents = parse_query_lines(lines)
        t.append(time.perf_counter())
        handles, fin_chunk = batch.search_batch_async(ents, backend="torch",
                                                      strict_alphabet=False, device=dev)
        t.append(time.perf_counter())

        def finish():
            t.append(time.perf_counter())
            for h in handles:
                h.wait()
            t.append(time.perf_counter())
            res = fin_chunk()
            t.append(time.perf_counter())
            return res

        res = run_on(finish)
        outs = [reply_line(q, r) for q, r in zip(ents, res)]
        t.append(time.perf_counter())
        split = {k: (b - a) * 1e3 for k, a, b in zip(
            ("parse", "dispatch", "handoff", "fetch_wait", "select", "format"), t, t[1:])}
        return {**split, "total": (t[-1] - t[0]) * 1e3}, outs

    def team():
        t0 = time.perf_counter()
        native.offset_stats_native(np.zeros(64, np.int32), np.zeros(8, np.int32),
                                   batch.build_tables_cached(np.array(BATCH["weights"]),
                                                             False))
        return (time.perf_counter() - t0) * 1e3

    third = new_thread()
    team_ms = third(team)
    out, got = [], []
    for c, (run_on, kind) in enumerate(((fin.call, "the warmup's"), (fin.call, "the warmup's"),
                                        (third, "new, after the tiny native call"),
                                        (new_thread(), "new"))):
        split, outs = chunk(queries[c * n:(c + 1) * n], run_on)
        out.append({"finishing_thread": kind, **split})
        got += outs
    fin.close()
    want = [reply_line(q, r) for q, r in zip(queries, batch.search_batch(queries,
                                                                          backend="native"))]
    print(json.dumps({"rc": rc, "warmup_s": warm_s, "team_ms": team_ms, "chunks": out,
                      "mismatches": mismatches([got], [want])}))
    return 0


def serve_warmup_phase(torch, sw, v2, v3, native, batch, Query, wide, dev, build):
    """Fresh `--serve --listen 127.0.0.1:0` processes with and without
    `--warmup`, each timed from its spawn to its listening line, then its
    first request (1 line or 256 lines), the first 256 lines on one shared
    Seq1, and WARMUP["steady"] more 256-line requests; every reply against
    the native engine's, and every `[warmup]` line before the listening
    line.  Then the warmup and a first chunk of each kind in this process,
    the launches counted around them and the device segments around the
    chunks.  A failure raises AssertionError."""
    from psa_torch.utils import cli as cli_mod
    from psa_torch.utils import server as server_mod

    t_phase = time.perf_counter()
    w = WARMUP
    n_b = w["batch"]
    rows = wide[: (w["steady"] + 1) * n_b]
    shared = [Query(q.weights, rows[0].seq1, q.seq2, q.is_max) for q in rows[:n_b]]
    want_rows = [reply_line(q, r) for q, r in
                 zip(rows, batch.search_batch(rows, backend="native"))]
    want_shared = [reply_line(q, r) for q, r in
                   zip(shared, batch.search_batch(shared, backend="native"))]
    row_lines = [serve_line(q) for q in rows]
    shared_lines = [serve_line(q) for q in shared]
    warm_file = ROOT / "psa_torch" / "_build" / "smoke" / "warmup.txt"
    warm_file.parent.mkdir(parents=True, exist_ok=True)
    warm_file.write_text("\n".join(shared_lines[-w["file_lines"]:]) + "\n")
    steady = [(f"steady_{i}", row_lines[(i + 1) * n_b:(i + 2) * n_b],
               want_rows[(i + 1) * n_b:(i + 2) * n_b]) for i in range(w["steady"])]
    runs = {}
    for warm in (False, True):
        for first in (1, n_b):
            sp = ServeProc(["--listen", "127.0.0.1:0", "--serve-batch", str(n_b),
                            *(["--warmup", str(warm_file)] if warm else [])])
            try:
                got, n_bad = serve_requests(sp, [
                    ("first", row_lines[:first], want_rows[:first]),
                    ("first_shared_s1", shared_lines, want_shared), *steady])
            finally:
                rc = sp.stop()
            late = [ln for ln in sp.err if ln.startswith("[warmup]")]
            warm_log = [ln for ln in sp.before if ln.startswith("[warmup]")]
            steady_chunks = [c for name, (_, log) in got.items()
                             if name.startswith("steady") for c in log]
            one = {"warmup": warm, "first_request_lines": first,
                   "spawn_to_listen_s": sp.listen_s,
                   "first_reply_ms": got["first"][0], "first_chunks": got["first"][1],
                   "first_shared_s1_reply_ms": got["first_shared_s1"][0],
                   "first_shared_s1_chunks": got["first_shared_s1"][1],
                   "steady_reply_ms": [got[name][0] for name, _, _ in steady],
                   "steady_chunk_ms_median": statistics.median(
                       ms for n, ms in steady_chunks if n == n_b) if any(
                       n == n_b for n, _ in steady_chunks) else None,
                   "steady_chunks": steady_chunks, "mismatches": n_bad, "rc": rc,
                   "warmup_log": warm_log, "stderr_before_listen": sp.before[-8:]}
            emit({"phase": "serve_warmup", **one})
            runs[warm, first] = one
            assert rc == 0 and n_bad == 0, \
                f"serve_warmup (warmup {warm}, first {first}): rc {rc}, {n_bad} mismatched"
            assert not late, f"[warmup] lines after the listening line: {late}"
            if warm:
                assert warm_log and warm_log[0].startswith("[warmup] kernels ") \
                    and warm_log[-1].startswith("[warmup] 1 bucket(s) warmed"), warm_log
            else:
                assert not warm_log, warm_log

    # the same warmup in this process, then a 256-line chunk per-row and on
    # one Seq1: launch counts zeroed just before the warmup and read after
    # the chunks; device segments read around the chunks
    args = cli_mod.build_parser().parse_args(
        ["--serve", "--quiet", "--listen", "127.0.0.1:0", "--serve-batch", str(n_b),
         "--warmup", str(warm_file)])
    cli_mod._fold_device_share(args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_launches(sw, v2, v3)
    native.calls.clear()
    t0 = time.perf_counter()
    rc = cli_mod._serve_warmup(args, dev, None)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    segments = [torch.cuda.memory_stats()["segment.all.allocated"]]
    chunk_ms, n_bad = [], 0
    for lines, want in ((row_lines[:n_b], want_rows[:n_b]), (shared_lines, want_shared)):
        t0 = time.perf_counter()
        outs = server_mod.dispatch_query_lines(lines, backend="torch", lenient=False,
                                               json_out=False, device=dev).finish()[0]
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        n_bad += mismatches([outs], [want])
    torch.cuda.synchronize()
    segments.append(torch.cuda.memory_stats()["segment.all.allocated"])
    launches = read_launches(sw, v2, v3)
    emit({"phase": "main_path_launches", "path": "serve_warmup", "rc": rc,
          "warmup_s": warm_s, "chunk_ms": chunk_ms, "mismatches": n_bad,
          "device_segments_before_after_chunks": segments, **launches,
          "native_calls": dict(native.calls)})
    assert rc == 0 and n_bad == 0, f"in-process warmup: rc {rc}, {n_bad} mismatched"
    # warm_kernels' two launches, the bucket's plain and shared ones, a chunk each
    assert launches["sweep_batched"] >= 3 and launches["sweep_batched_shared"] >= 3, launches
    assert launches["epilogue"] == launches["sweep_batched"] + launches["sweep_batched_shared"]
    assert segments[1] == segments[0], f"the warmed chunks allocated segments: {segments}"
    assert native.calls.get("search", 0) == 0, "a host engine answered"

    # what a warmed process's first chunks still pay, phase by phase, in a
    # new process (this one has run everything before)
    p = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.serve_warmup_split_child(sys.argv[1]))", str(warm_file)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, f"serve_warmup_split_child: rc {p.returncode}: {p.stderr[-2000:]}"
    child = json.loads(p.stdout.strip().splitlines()[-1])
    emit({"phase": "serve_warmup_first_chunks_ms", **child})
    assert child["rc"] == 0 and child["mismatches"] == 0, \
        f"serve_warmup_split_child: rc {child['rc']}, {child['mismatches']} mismatched"

    def pick(warm, first, key):
        return runs[warm, first][key]

    emit({"phase": "serve_warmup_summary",
          "nvcc_build_s": "cached" if build["cached"] else build["seconds"],
          "spawn_to_listen_s": {f"warmup_{w_}": [pick(w_, f, "spawn_to_listen_s")
                                                 for f in (1, n_b)]
                                for w_ in (False, True)},
          **{f"first_{f}_line_reply_ms": {f"warmup_{w_}": pick(w_, f, "first_reply_ms")
                                          for w_ in (False, True)} for f in (1, n_b)},
          **{f"first_{f}_line_chunk_ms": {f"warmup_{w_}": [ms for _, ms in
                                                         pick(w_, f, "first_chunks")]
                                          for w_ in (False, True)} for f in (1, n_b)},
          "steady_chunk_ms_median": {f"warmup_{w_}": [pick(w_, f, "steady_chunk_ms_median")
                                                      for f in (1, n_b)]
                                     for w_ in (False, True)},
          "seconds": time.perf_counter() - t_phase})


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
        if (got != NORTH_STAR_WINNER or launches["sweep"] != shards or fell
                or launches["epilogue"] != shards):
            raise AssertionError(f"north star sharded {kind} {shape}: {got}, "
                                 f"{launches['sweep']} sweep launches, "
                                 f"{launches['epilogue']} epilogues, {fell} fallbacks")
        med, lo, hi = wall_ms(fn, runs=5)
        runs.append({"mesh": kind, "shape": shape, "shards": shards,
                     "winner": list(got), "sweep_launches": launches["sweep"],
                     "epilogue_launches": launches["epilogue"],
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
              "sweep_launches": launches["sweep"],
              "epilogue_launches": launches["epilogue"], "ms": ms})
        if not same_bits(got, want) or mesh_mod.fallbacks != 1 \
                or launches["sweep"] != 8 or launches["epilogue"] != 4:
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
                         sweep_launches=launches["sweep"],
                         epilogue_launches=launches["epilogue"], fallbacks=fell)
        if launches["sweep"] < shards or launches["epilogue"] != shards:
            raise AssertionError(f"600k x 250k through {tag} launched sweep "
                                 f"{launches['sweep']} times, the epilogue "
                                 f"{launches['epilogue']}")
    t0 = time.perf_counter()
    want = eng_native.search_codes(c1l, c2l)
    native_ms = (time.perf_counter() - t0) * 1e3
    _, _, l2p, l1k = sw.plan_shapes(c1l.shape[0], c2l.shape[0])
    dtabs = device_tables_cached(tables, cuda0)
    packed, _ = batch.run_exact(*sw.upload_codes(cuda0, (c1l, l1k), (c2l, l2p)), noff,
                                dtabs)
    near = int(batch.unpack_epilogue_outputs(packed.cpu().numpy(), batch.TOPK)[2][0])
    emit({"phase": "long_seq2", "n1": LONG_SEQ2["n1"], "n2": LONG_SEQ2["n2"],
          "pair_evals": float(noff) * LONG_SEQ2["n2"],
          "native": list(winner(want)), "native_ms": native_ms,
          "near": near, "near_gt_k": near > batch.TOPK,
          "eps_f32": dtabs.eps(l2p), "auto_shape": list(shape),
          **{tag: {"winner": list(winner(v["result"])),
                   "equal_bits": same_bits(v["result"], want),
                   **{k: v[k] for k in ("first_ms", "ms", "min", "max",
                                        "sweep_launches", "epilogue_launches",
                                        "fallbacks")}}
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
        if got != bres[name] or launches[kernel] != 4 or launches["epilogue"] != 4:
            raise AssertionError(f"sharded batch {name}: equal {got == bres[name]}, "
                                 f"{launches[kernel]} {kernel} launches, "
                                 f"{launches['epilogue']} epilogues")


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


# The differential engines (`--backend conv`, `--backend xla`) are held
# against the native engine's stats at the north star, at 70,511 x 70,000
# (Seq2 past 65,536: a 70k-wide conv filter) and at 1,000,000 x 2,048;
# (name, n1, n2, seed).
ENGINE_SHAPES = [("north_star", 100_000, 10_000, 30), ("seq2_70000", 70_511, 70_000, 31),
                 ("seq1_1M", 1_000_000, 2048, 32)]
# `trace`: the traced serve wave is the batch workload's per-row queries this
# many times over (4096 lines), in chunks of this many lines.
TRACE_SERVE_REPEAT = 4
TRACE_SERVE_BATCH = 256
# `sharded_xla`: the north star over this many shards of the card.
SHARDED_XLA_SHARDS = 4


def conv_algorithms_child(spec: str) -> int:
    """Body of the `conv_algorithms` child process: each conv of spec (a
    JSON list of [label, input shape, filter shape, groups]) on random 0/1
    f32 operands, once with cuDNN's heuristic choice and once autotuned
    (`torch.backends.cudnn.benchmark`), each in a `record_function` range
    of one profiler session.  Prints {label/choice: [[kernel, device us],
    ...]} as one JSON line: the kernels whose device time falls in each
    range, longest first.  The names say which algorithm cuDNN took
    (implicit GEMM on CUDA cores or tensor cores, FFT, Winograd)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from psa_torch.ops import engine_conv as ec

    torch.manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for label, xs, ks, groups in json.loads(spec):
            x = (torch.rand(xs, device="cuda") < 0.5).float()
            k = (torch.rand(ks, device="cuda") < 0.5).float()
            for choice, autotune in (("heuristic", False), ("autotuned", True)):
                torch.backends.cudnn.benchmark = autotune
                ec.conv1d_f32(x, k, groups=groups)       # autotunes once
                torch.cuda.synchronize()
                with record_function(f"{label}/{choice}"):
                    ec.conv1d_f32(x, k, groups=groups)
                    torch.cuda.synchronize()
            del x, k
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and "/" in e["name"]]
    out: dict = {r["name"]: {} for r in ranges}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        mid = e["ts"] + e["dur"] / 2
        for r in ranges:
            if r["ts"] <= mid <= r["ts"] + r["dur"]:
                out[r["name"]][e["name"]] = out[r["name"]].get(e["name"], 0.0) + e["dur"]
    print(json.dumps({name: sorted(ks.items(), key=lambda kv: -kv[1])[:3]
                      for name, ks in out.items()}), flush=True)
    return 0


def conv_algorithms(convs: list) -> dict:
    """The cuDNN kernels of each conv in convs ([label, input shape, filter
    shape, groups]), by choice, from `conv_algorithms_child` in a new
    process: late in this long-lived process the profiler loses the conv's
    events (PERF.md §7), in a new one it records them."""
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.conv_algorithms_child(sys.argv[1]))",
         json.dumps(convs)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, f"conv_algorithms: rc {p.returncode}: {p.stderr[-2000:]}"
    return json.loads(p.stdout.strip().splitlines()[-1])


def run_cli(cli_mod, argv):
    """(exit code, stdout, host seconds) of `psa_torch.utils.cli.main(argv)`
    in this process."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_mod.main(argv)
    return rc, out.getvalue(), time.perf_counter() - t0


def engines_phase(torch, sw, v2, v3, native, dev, s1, s2, ns_file: Path, ns_bytes: str,
                  cases_txt: Path, numpy_batch: tuple, work: Path):
    """The differential engines on the card: the north star through
    `AlignmentSearchEngine(backend="conv"|"xla")` with the kernels' counts
    zeroed around it (neither runs a sweep kernel), their stats equal to the
    native engine's at ENGINE_SHAPES in both modes, each engine's warm time,
    the conv's largest distance from an integer before rounding (the
    kernels cuDNN ran come from `conv_algorithms`), and `psa-torch
    --backend conv|xla` byte-equal to
    `--backend numpy` (single, and `--batch` on the mixed file).  Any
    failure raises.  numpy_batch is (exit code, {name: bytes}) of
    `--batch --backend numpy` on cases_txt."""
    from psa_torch.core.tables import build_tables
    from psa_torch.models.search import AlignmentSearchEngine
    from psa_torch.ops import engine_conv, engine_xla
    from psa_torch.utils import cli as cli_mod

    # the numpy oracle's CLI on the north star takes ~15 s of one host core:
    # it runs beside the card's phases
    ref_out = work / "engines_numpy.txt"
    ref_out.unlink(missing_ok=True)
    ref_proc = subprocess.Popen([sys.executable, "-m", "psa_torch.utils.cli", str(ns_file),
                                 "-o", str(ref_out), "--quiet", "--backend", "numpy"],
                                cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                text=True)
    try:
        ns = {}
        for backend in ("conv", "xla"):
            e = AlignmentSearchEngine(NORTH_STAR["weights"], NORTH_STAR["is_max"],
                                      backend=backend)
            zero_launches(sw, v2, v3)
            t0 = time.perf_counter()
            r = e.search(s1, s2)
            first_s = time.perf_counter() - t0
            launches = read_launches(sw, v2, v3)
            ms = wall_ms(lambda: e.search(s1, s2), runs=5)
            ns[backend] = {"winner": list(winner(r)), "first_call_s": first_s,
                           "warm_ms": ms, **launches}
            emit({"phase": "main_path_launches", "path": f"north_star_{backend}",
                  "winner": list(winner(r)), **launches})
            assert winner(r) == NORTH_STAR_WINNER, \
                f"north star through {backend}: {winner(r)} != {NORTH_STAR_WINNER}"
            assert sum(launches.values()) == 0, \
                f"{backend} launched a sweep or epilogue kernel"

        rng = np.random.default_rng(300)
        shapes = []
        for name, n1, n2, seed in ENGINE_SHAPES:
            srng = np.random.default_rng(seed)
            c1, c2 = random_codes(srng, n1), random_codes(srng, n2)
            row = {"case": name, "n1": n1, "n2": n2}
            for is_max in (False, True):
                t = build_tables(np.array(NORTH_STAR["weights"]), is_max)
                t0 = time.perf_counter()
                want_c, want_m = native.offset_stats_native(c1, c2, t)
                row[f"native_s_{int(is_max)}"] = time.perf_counter() - t0
                for engine, fn in (("conv", engine_conv.offset_stats_conv),
                                   ("xla", engine_xla.offset_stats_xla)):
                    got_c, got_m = fn(c1, c2, t, dev)
                    equal = (np.array_equal(got_c, want_c) and np.array_equal(got_m, want_m))
                    row[f"{engine}_equal_{'max' if is_max else 'min'}"] = equal
                    assert equal, f"{engine} stats differ from native at {name}, is_max={is_max}"
                    if not is_max:
                        row[f"{engine}_ms"] = wall_ms(lambda: fn(c1, c2, t, dev), runs=3)
            # the conv's output before rounding, on the engine's own operands
            t = build_tables(np.array(NORTH_STAR["weights"]), False)
            x = engine_conv.onehot_seq1(torch.from_numpy(c1.astype(np.uint8)).to(dev))[None]
            k = engine_conv.indicator_filter(torch.from_numpy(t.code).to(dev),
                                             torch.from_numpy(c2.astype(np.uint8)).to(dev),
                                             t.num_ranks)
            out = engine_conv.conv1d_f32(x, k)
            row["conv_max_int_err"] = float((out - out.round()).abs().max())
            row["conv_out_max"] = float(out.max())
            row["conv_shape"] = {"x": list(x.shape), "k": list(k.shape), "out": list(out.shape)}
            del x, k, out
            shapes.append(row)
            emit({"phase": "engines_stats", **row})

        # the CLI: --backend conv and xla on the north-star file, in this
        # process, against --backend numpy's file; then --batch --backend
        # conv on the mixed file against its numpy files
        cli_rows = {}
        for backend in ("conv", "xla"):
            o = work / f"engines_{backend}.txt"
            o.unlink(missing_ok=True)
            rc, _, secs = run_cli(cli_mod, [str(ns_file), "-o", str(o), "--quiet",
                                            "--backend", backend])
            cli_rows[backend] = (rc, o.read_text() if o.is_file() else None, secs)
        bdir = work / "engines_batch_conv"
        shutil.rmtree(bdir, ignore_errors=True)
        rc_b, _, secs_b = run_cli(cli_mod, [str(cases_txt), "--batch", "--lenient", "--quiet",
                                            "--backend", "conv", "-o", str(bdir)])
        batch_files = {f.name: f.read_bytes() for f in sorted(bdir.glob("out_*.txt"))}
        ref_err = ref_proc.communicate(timeout=600)[1]
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    ref_text = ref_out.read_text() if ref_out.is_file() else None
    emit({"phase": "engines", "north_star": ns, "numpy_rc": ref_proc.returncode,
          "cli": {b: {"rc": rc, "bytes_equal_numpy": text == ref_text, "seconds": secs}
                  for b, (rc, text, secs) in cli_rows.items()},
          "cli_batch_conv": {"rc": rc_b, "files": len(batch_files),
                             "bytes_equal_numpy": batch_files == numpy_batch[1],
                             "seconds": secs_b},
          "numpy_stderr_tail": ref_err[-300:]})
    assert ref_proc.returncode == 0 and ref_text == ns_bytes, \
        "psa-torch --backend numpy on the north star differs from the card's bytes"
    for b, (rc, text, _) in cli_rows.items():
        assert rc == 0 and text == ref_text, f"psa-torch --backend {b} differs from numpy"
    assert (rc_b, batch_files) == numpy_batch, \
        "psa-torch --batch --backend conv differs from --backend numpy"


def library_calls_phase(torch, sw, v2, v3, dev, tables, big1, big2, rng):
    """The one PyTorch call that computes each kernel's statistics (a conv1d
    of the one-hot Seq1 with the indicator filters, ops/engine_conv.py),
    checked equal to the kernel's counts and max rank on the same inputs,
    then timed beside the kernel, both by one launch and back to back:
    conv1d at 100k x 10k for `sweep`, a grouped conv1d (groups = B) on the
    batch workload for `sweep_batched`, one conv1d of B x F filters on the
    shared Seq1 for `sweep_batched_shared`, conv1d at 131072 x 8192 for
    `sweep_v2` and `sweep_v3`.  Each call runs with cuDNN's heuristic choice
    of algorithm (as the conv engine runs) and autotuned
    (`torch.backends.cudnn.benchmark`, set in this phase only); where a
    group's 4 + num_ranks filters are no multiple of 8, also with them
    padded by zero filters to one (`padded`, `padded_autotuned`), the
    channel alignment cuDNN's tensor-core kernels take.  library_ms is the
    fastest of these that agrees with the kernel.  The kernels each choice
    ran are named by `conv_algorithms`, with the engines' convs.
    Returns {kernel: row}; a row whose call does not fit or is refused
    holds the reason and library_ms None."""
    from psa_torch.ops import engine_conv as ec

    code = torch.from_numpy(tables.code).to(dev)
    nr = tables.num_ranks
    rows = {}
    convs = [[f"engine_{name}", [1, 32, n1], [4 + nr, 32, n2], 1]
             for name, n1, n2, _ in ENGINE_SHAPES]

    def measure(name, kernel_fn, kernel_stats, build, check_rows=slice(0, 5)):
        row = {"kernel": name}
        want = kernel_stats()
        width = want.shape[-1]
        (k_ms, _, _), (k_bb, _, _) = kernel_times(torch, kernel_fn, runs=20)
        row.update(kernel_ms=k_ms, kernel_ms_back_to_back=k_bb)
        try:
            x, k, groups, shape = build()
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
            torch.cuda.empty_cache()
            row.update(library_ms=None, reason=f"{type(e).__name__}: {str(e)[:300]}")
            emit({"phase": "library_calls", **row})
            rows[name] = row
            return
        row.update(x=list(x.shape), filter=list(k.shape), groups=groups)
        variants = [("heuristic", k, shape, False), ("autotuned", k, shape, True)]
        f = k.shape[0] // groups
        fp = -(-f // 8) * 8
        if fp != f:
            kp = torch.zeros((groups, fp, *k.shape[1:]), dtype=k.dtype, device=k.device)
            kp[:, :f] = k.reshape(groups, f, *k.shape[1:])
            kp = kp.reshape(groups * fp, *k.shape[1:])
            shp = (*shape[:-2], fp, shape[-1])
            variants += [("padded", kp, shp, False), ("padded_autotuned", kp, shp, True)]
            row["padded_filter"] = list(kp.shape)
        for choice, kk, _, autotune in variants:
            if not autotune and [list(x.shape), list(kk.shape), groups] not in [
                    c[1:] for c in convs]:
                convs.append([f"library_{name}_{choice}", list(x.shape), list(kk.shape),
                              groups])
        for choice, kk, shp, autotune in variants:
            call = lambda kk=kk: ec.conv1d_f32(x, kk, groups=groups)  # noqa: E731
            torch.backends.cudnn.benchmark = autotune
            try:
                out = call()                    # an autotuned call chooses here
                err = float((out - out.round()).abs().max())
                st = ec.stats5_from_conv(out.reshape(shp)[..., :f, :])
            except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
                torch.cuda.empty_cache()
                row[choice] = {"library_ms": None,
                               "reason": f"{type(e).__name__}: {str(e)[:300]}"}
                continue
            equal = bool(torch.equal(st[..., check_rows, :width], want[..., check_rows, :]))
            del st, out
            res = {"conv_max_int_err": err, "equal_to_kernel": equal}
            # the heuristic choice is the conv engine's: it must agree
            assert equal or choice != "heuristic", \
                f"the library call of {name} differs from the kernel"
            if not equal:
                res.update(library_ms=None, reason="its output differs from the kernel's")
                row[choice] = res
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            # a slow call is timed over fewer runs, to keep the phase short
            (l_ms, l_q1, l_q3), (l_bb, _, _) = kernel_times(
                torch, call, runs=10 if first_ms < 20 else 3)
            res.update(library_ms=l_ms, library_ms_iqr=[l_q1, l_q3],
                       library_ms_back_to_back=l_bb, ratio=l_ms / k_ms,
                       ratio_back_to_back=l_bb / k_bb)
            row[choice] = res
        timed = [c for c in ("heuristic", "autotuned", "padded", "padded_autotuned")
                 if row.get(c, {}).get("library_ms") is not None]
        if timed:
            best = min(timed, key=lambda c: row[c]["library_ms"])
            row.update(library_ms=row[best]["library_ms"], library_choice=best,
                       ratio=row[best]["ratio"])
        else:
            row.update(library_ms=None, reason=row["heuristic"]["reason"])
        emit({"phase": "library_calls", **row})
        rows[name] = row

    # sweep: one query at the north star's shape
    c1 = random_codes(rng, 100_000)
    c2 = random_codes(rng, 10_000)
    noff, _, l2p, l1k = sw.plan_shapes(c1.shape[0], c2.shape[0])
    d1, d2 = sw.upload_codes(dev, (c1, l1k), (c2, l2p))
    measure("sweep", lambda: sw.sweep(d1, d2, code),
            lambda: sw.sweep(d1, d2, code)[:, :noff],
            lambda: (ec.onehot_seq1(d1[: c1.shape[0]])[None],
                     ec.indicator_filter(code, d2[: c2.shape[0]], nr), 1, (4 + nr, -1)))
    # the batched kernels on the batch workload (B = 1024 of 2048 x 512 at
    # the path's padding): B groups of one query each, and B x F filters on
    # the one Seq1
    b, l1b = big1.shape
    l2b = big2.shape[1]
    measure("sweep_batched", lambda: sw.sweep_batched(big1, big2, code),
            lambda: sw.sweep_batched(big1, big2, code),
            lambda: (ec.onehot_seq1(big1).reshape(1, b * 32, l1b),
                     ec.indicator_filter(code, big2, nr).reshape(b * (4 + nr), 32, l2b),
                     b, (b, 4 + nr, -1)))
    row0 = big1[0].contiguous()
    measure("sweep_batched_shared", lambda: sw.sweep_batched_shared(row0, big2, code),
            lambda: sw.sweep_batched_shared(row0, big2, code),
            lambda: (ec.onehot_seq1(row0)[None],
                     ec.indicator_filter(code, big2, nr).reshape(b * (4 + nr), 32, l2b),
                     1, (b, 4 + nr, -1)))
    # the lab's kernels at the lab's shape (clean codes; v3's row 3 is zero,
    # so its check reads rows 0-2 and the max rank)
    c1 = random_codes(rng, LAB["n1"])
    c2 = random_codes(rng, LAB["n2"])
    noff, _, l2p, l1k = v2.plan_shapes_v2(c1.shape[0], c2.shape[0])
    d1, d2 = sw.upload_codes(dev, (c1, l1k), (c2, l2p))
    lab_build = lambda: (ec.onehot_seq1(d1[: c1.shape[0]])[None],  # noqa: E731
                         ec.indicator_filter(code, d2[: c2.shape[0]], nr), 1, (4 + nr, -1))
    for name, fn in (("sweep_v2", v2.sweep_v2), ("sweep_v3", v3.sweep_v3)):
        measure(name, lambda fn=fn: fn(d1, d2, code),
                lambda fn=fn: sw.stats5_from_sweep(fn(d1, d2, code))[:, :noff],
                lab_build, check_rows=[0, 1, 2, 4] if name == "sweep_v3" else slice(0, 5))
    emit({"phase": "conv_algorithms", "convs": convs, "kernels": conv_algorithms(convs)})
    return rows


def trace_events(logdir: Path) -> list:
    files = sorted(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1, f"{logdir}: {len(files)} trace files"
    return json.loads(files[0].read_text())["traceEvents"]


def trace_summary(events: list) -> dict:
    """Device-busy share of a Chrome trace: the device events' time (kernels,
    copies, memsets) over the span of every event, and the kernels by
    name."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    span = (max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)
            if timed else 0.0)
    busy = sum(e["dur"] for e in dev)
    kernels: dict = {}
    for e in dev:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    return {"device_busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "device_busy_share": busy / span if span else None,
            "kernel_events": sum(kernels.values()),
            "top_kernels": sorted(kernels.items(), key=lambda kv: -kv[1])[:5]}


def run_cli_process(argv, stdin_text: str | None = None):
    """(exit code, stdout, wall seconds) of `python -m psa_torch.utils.cli
    argv` as a process of its own, as a user runs it."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "psa_torch.utils.cli", *argv], cwd=ROOT,
                       input=stdin_text, capture_output=True, text=True, timeout=600)
    return p.returncode, p.stdout, time.perf_counter() - t0


def trace_phase(work: Path, ns_file: Path, untraced_single: tuple, cases_txt: Path,
                untraced_batch: tuple, serve_lines: list, serve_want: list):
    """`psa-torch --trace DIR` on the single-query, `--batch` and `--serve`
    paths, each as a process of its own: each traced run writes one trace
    file holding the expected kernels' events, and its outputs equal the
    untraced run's.  The untraced single-query and `--batch` runs are the
    `cli` and `cli_batch` phases' processes, given as (output, wall
    seconds); the serve wave runs untraced here, its replies held against
    serve_want.  The serve wave is long (thousands of lines, one launch or
    more per chunk of TRACE_SERVE_BATCH), and its trace must hold a
    `sweep_batched_kernel` event for every chunk: none may be lost late in
    the run.  Prints each traced run's device-busy share and its wall time
    beside the untraced run's."""
    text = "\n".join(serve_lines) + "\n"
    chunks = -(-len(serve_lines) // TRACE_SERVE_BATCH)
    runs = (("single", "sweep_kernel",
             lambda o, extra: run_cli_process([str(ns_file), "-o", str(o), "--quiet", *extra]),
             lambda o, _: o.read_text() if o.is_file() else None),
            ("batch", "sweep_batched_kernel",
             lambda o, extra: run_cli_process([str(cases_txt), "--batch", "--lenient",
                                               "--quiet", "-o", str(o), *extra]),
             lambda o, _: {f.name: f.read_bytes() for f in sorted(o.glob("out_*.txt"))}),
            ("serve", "sweep_batched_kernel",
             lambda o, extra: run_cli_process(["--serve", "--quiet", "--serve-batch",
                                               str(TRACE_SERVE_BATCH), *extra],
                                              stdin_text=text),
             lambda _, stdout: stdout))
    want = {"single": untraced_single[0], "batch": untraced_batch[0],
            "serve": "\n".join(serve_want) + "\n"}
    for name, kernel, run, result in runs:
        got = {}
        logdir = work / f"trace_{name}_dir"
        if name == "single":
            got["plain"] = (0, *untraced_single)
        elif name == "batch":
            got["plain"] = (1, *untraced_batch)
        for tag in ("plain", "traced"):
            if tag in got:
                continue
            o = work / f"trace_{name}_{tag}" if name == "batch" else work / f"trace_{name}_{tag}.txt"
            if name == "batch":
                shutil.rmtree(o, ignore_errors=True)
            else:
                o.unlink(missing_ok=True)
            shutil.rmtree(logdir, ignore_errors=True)
            extra = ["--trace", str(logdir)] if tag == "traced" else []
            rc, stdout, secs = run(o, extra)
            got[tag] = (rc, result(o, stdout), secs)
        events = trace_events(logdir)
        summ = trace_summary(events)
        n_kernel = sum(kernel in e.get("name", "") for e in events
                       if e.get("cat") == "kernel")
        least = chunks if name == "serve" else 1
        emit({"phase": "trace", "path": name, "rc": [got["plain"][0], got["traced"][0]],
              "equal_untraced": got["traced"][1] == got["plain"][1],
              "equal_want": got["plain"][1] == want[name],
              "wall_s_untraced": got["plain"][2], "wall_s_traced": got["traced"][2],
              kernel + "_events": n_kernel, "least_events": least,
              "trace_mb": sum(f.stat().st_size for f in logdir.glob("*.json")) / 1e6,
              **summ})
        assert got["traced"][:2] == got["plain"][:2] and got["plain"][1] == want[name], \
            f"--trace changed the {name} path's exit code or output"
        assert n_kernel >= least, \
            f"the {name} trace holds {n_kernel} {kernel} events, fewer than {least}"


def sharded_xla_phase(torch, sw, v2, v3, mesh_mod, tables, c1, c2, dev, ns_file: Path,
                      ns_bytes: str, work: Path):
    """The north star through `search_sharded(kernel="xla")` on
    SHARDED_XLA_SHARDS shards of the card (no sweep kernel launched), and
    `psa-torch --sharded --backend xla`, both equal to the unsharded
    result."""
    from psa_torch.utils import cli as cli_mod

    mesh = [dev] * SHARDED_XLA_SHARDS
    mesh_mod.fallbacks = 0
    zero_launches(sw, v2, v3)
    r = mesh_mod.search_sharded(c1, c2, tables, mesh, kernel="xla")
    launches = read_launches(sw, v2, v3)
    ms = wall_ms(lambda: mesh_mod.search_sharded(c1, c2, tables, mesh, kernel="xla"), runs=3)
    o = work / "sharded_xla.txt"
    o.unlink(missing_ok=True)
    rc, _, secs = run_cli(cli_mod, [str(ns_file), "-o", str(o), "--quiet", "--sharded",
                                    "--backend", "xla"])
    cli_equal = rc == 0 and o.is_file() and o.read_text() == ns_bytes
    emit({"phase": "sharded_xla", "shards": len(mesh), "winner": list(winner(r)),
          "fallbacks": mesh_mod.fallbacks, "ms": ms, **launches,
          "cli_rc": rc, "cli_bytes_equal": cli_equal, "cli_seconds": secs})
    assert winner(r) == NORTH_STAR_WINNER, f"sharded xla: {winner(r)}"
    assert sweep_launches(launches) == 0, "the xla shards launched a sweep kernel"
    assert launches["epilogue"] == len(mesh), \
        f"the xla shards launched the epilogue {launches['epilogue']} times"
    assert cli_equal, "psa-torch --sharded --backend xla differs"


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
    from psa_torch.ops import epilogue as ep
    from psa_torch.ops import sweep as sw
    from psa_torch.parallel import mesh as mesh_mod
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
    build_cached = (sw._BUILD_DIR / f"libpsa_sweep_{sw._build_tag()}.so").exists()
    t0 = time.perf_counter()
    lib = sw.build_library()
    build_s = time.perf_counter() - t0
    logs = sorted((sw._BUILD_DIR).glob("*.log"))
    ptxas = [ln.strip() for ln in (logs[-1].read_text().splitlines() if logs else [])
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit({"phase": "build", "seconds": build_s, "cached": build_cached,
          "library": Path(lib._name).name, "ptxas": ptxas})
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
        # 3a. the epilogue kernel at every shape the paths give it, and the
        # device events of one warm north-star query in a new process
        t_ep = time.perf_counter()
        ep_times, ep_err = epilogue_kernel_phase(torch, sw, ep, mesh_mod, dev, encode,
                                         random_sequences, build_tables, device_tables,
                                         (big1, big2))
        ep_count = epilogue_launch_count()
        emit({"phase": "epilogue_phases_elapsed", "seconds": time.perf_counter() - t_ep})
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
    if single_launches["epilogue"] != 1 + len(queries):
        return fail(f"the single-query path ran the epilogue kernel "
                    f"{single_launches['epilogue']} times for {1 + len(queries)} queries")
    if single_launches["epilogue_cuda_launches"] != single_launches["epilogue"]:
        return fail(f"{single_launches['epilogue_cuda_launches']} CUDA launches for "
                    f"{single_launches['epilogue']} epilogue calls")
    if single_native.get("rescore_multi", 0) < 1 + len(queries):
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
        if launches["sweep"] != (1 if on_card else 0) \
                or launches["epilogue"] != launches["sweep"]:
            return fail(f"north star through {tag} launched sweep "
                        f"{launches['sweep']} times, the epilogue {launches['epilogue']}")
        if on_card and calls.get("rescore_multi", 0) != 1:
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
    if batch_launches["epilogue"] != (batch_launches["sweep_batched"]
                                      + batch_launches["sweep_batched_shared"]):
        return fail("the batch path did not run one epilogue kernel per batched launch")
    if min(batch_native.get(k, 0) for k in ("rescore_multi", "encode_checked")) < 1:
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
    if got_launches != want_launches or file_launches["epilogue"] != want_launches:
        return fail(f"search_batch took {got_launches} batched launches and "
                    f"{file_launches['epilogue']} epilogues on the "
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
        # 4d'. the serve warm start: new servers with and without --warmup
        serve_warmup_phase(torch, sw, v2, v3, native, batch, Query, wide, dev,
                           {"seconds": build_s, "cached": build_cached})
    except AssertionError as e:
        return fail(str(e))

    # 4e. the sharded and multi-process paths: the north star on meshes of
    # 1-8 shards of the one card (1-D and 2-D), the all-'A' fallback, 600k x
    # 250k through `torch` and a 4-shard mesh against native, the batch
    # workload sharded over 4, then two ranks on the card and --sharded
    t_par = time.perf_counter()
    try:
        sharded_phases(torch, sw, v2, v3, mesh_mod, batch, eng, ns_engines["native"],
                       eng.tables, s1, s2, encode, random_sequences, bq, bres)
        distributed_phases(inp, want_bytes, cases_txt, fn, work)
    except AssertionError as e:
        return fail(str(e))
    emit({"phase": "parallel_elapsed", "seconds": time.perf_counter() - t_par})

    # 4f. the differential engines (`--backend conv`, `--backend xla`) on the
    # card, `--trace` on the single-query, batch and serve paths, and the
    # north star through the sharded path's xla kernel
    t_new = time.perf_counter()
    serve_qs = bq["per_row"] * TRACE_SERVE_REPEAT
    try:
        engines_phase(
            torch, sw, v2, v3, native, dev, s1, s2, inp, want_bytes, cases_txt,
            (pn.returncode, fn), work)
        trace_phase(work, inp, (want_bytes, cli_s), cases_txt, (fc, pc_s),
                                 [serve_line(q) for q in serve_qs],
                                 [reply_line(q, r) for q, r in
                                  zip(serve_qs, bres["per_row"] * TRACE_SERVE_REPEAT)])
        sharded_xla_phase(torch, sw, v2, v3, mesh_mod, eng.tables, encode(s1), encode(s2),
                          dev, inp, want_bytes, work)
    except AssertionError as e:
        return fail(str(e))
    new_phases_s = time.perf_counter() - t_new

    # 5. times on the card
    timings = {}
    for name, n1, n2 in (("bench", 131072, 8192), ("north_star", 100_000, 10_000),
                         ("long_seq1", 400_000, 2048), ("seq1_1M", 1_000_000, 2048)):
        c1 = random_codes(rng, n1)
        c2 = random_codes(rng, n2)
        noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
        d1, d2 = sw.upload_codes(dev, (c1, l1k), (c2, l2p))
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
        d1, d2 = sw.upload_codes(dev, (c1n, l1k), (c2n, l2p))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        stats5 = sw.sweep(d1, d2, dtabs.code)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        packed = ep.epilogue_pack(stats5[None], dtabs, noff, l2p)
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
    packed_l, _ = batch.run_exact(*sw.upload_codes(dev, (c1l, l1k_l), (c2l, l2p_l)),
                                  noff_l, dtabs)
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

    batched_cell_phase(torch, sw, code, dev)
    ab = sweep_ab_phase()
    if not ab.get("digests_agree"):
        return fail("the sweeps' outputs differ between the timed trees")

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
        d1, d2 = sw.upload_codes(dev, (random_codes(rng, n1), l1k),
                                 (random_codes(rng, n2), l2p))
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

    # 5d. the one library call that computes each kernel's statistics,
    # checked against the kernel and timed beside it
    t_lib = time.perf_counter()
    autotune = torch.backends.cudnn.benchmark
    try:
        library = library_calls_phase(torch, sw, v2, v3, dev, t_ns, big1, big2, rng)
    except AssertionError as e:
        return fail(str(e))
    finally:
        torch.backends.cudnn.benchmark = autotune
    new_phases_s += time.perf_counter() - t_lib

    # 6. the ported kernels
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start,
          "engines_trace_library_seconds": new_phases_s})
    print(smi_line, flush=True)
    shape_b = f"{b}x{BATCH['n1']}x{BATCH['n2']} (noff_pad {noff_pad_b})"
    emit({"kernels": [
        {"name": "sweep", "route": "cuda", "source": "psa_torch/csrc/sweep.cu",
         "replaces": "psa_tpu/ops/pallas_sweep.py:297",
         "launches": single_launches["sweep"], "max_abs_err": max_abs,
         "max_abs_diff": max_abs, "shape": "100000x10000",
         **timings["north_star"], "library_ms": library["sweep"]["library_ms"]},
        {"name": "sweep_batched", "route": "cuda",
         "source": "psa_torch/csrc/sweep_batched.cu",
         "replaces": "psa_tpu/ops/pallas_sweep.py:365",
         "launches": batch_launches["sweep_batched"],
         "max_abs_err": batched_abs["sweep_batched"],
         "max_abs_diff": batched_abs["sweep_batched"], "shape": shape_b,
         **ktimes["sweep_batched"], "library_ms": library["sweep_batched"]["library_ms"]},
        {"name": "sweep_batched_shared", "route": "cuda",
         "source": "psa_torch/csrc/sweep_batched.cu",
         "replaces": "psa_tpu/ops/pallas_sweep.py:492",
         "launches": batch_launches["sweep_batched_shared"],
         "max_abs_err": batched_abs["sweep_batched_shared"],
         "max_abs_diff": batched_abs["sweep_batched_shared"], "shape": shape_b,
         **ktimes["sweep_batched_shared"],
         "library_ms": library["sweep_batched_shared"]["library_ms"]},
        *({"name": kernel, "route": "cuda", "source": source,
           "replaces": replaces, "launches": lab_launches[kernel],
           "max_abs_err": lab_abs[kernel], "max_abs_diff": lab_abs[kernel],
           "shape": f"{LAB['n1']}x{LAB['n2']}", **lab_times[kernel, "bench"],
           "library_ms": library[kernel]["library_ms"]}
          for kernel, source, replaces in (
              ("sweep_v2", "psa_torch/csrc/sweep_mma.cu", "psa_tpu/ops/_sweep_v2.py:86"),
              ("sweep_v3", "psa_torch/csrc/sweep_mma_v3.cu",
               "psa_tpu/ops/_sweep_v3.py:101"))),
        {"name": "epilogue", "route": "cuda", "source": "psa_torch/csrc/epilogue.cu",
         "replaces": "psa_tpu/models/batch.py:643 (XLA code, not a Pallas kernel)",
         "launches": single_launches["epilogue"],
         "cuda_launches": single_launches["epilogue_cuda_launches"],
         "cuda_launches_per_north_star_query": ep_count["epilogue_kernels"],
         "max_abs_err": ep_err, "max_abs_diff": ep_err, "compared_by": "torch.equal",
         "shape": "1x5x90112", "device_events_per_query": ep_count["device_events"],
         "device_us": ep_count["device_us"]["north_star"],
         "launch_floor_ms": ep_times["launch_floor"]["ms"],
         **ep_times["north_star"], "library_ms": None}]})
    # 7. last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
