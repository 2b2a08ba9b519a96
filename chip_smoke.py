#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (psa_torch) on one GPU.

    python3 chip_smoke.py

Builds the sweep kernel from psa_torch/csrc, holds it against its plain
PyTorch version on the card, drives the port's main path (the engine and the
`psa_torch.utils.cli` CLI) at the 100k x 10k north-star size, times the
kernel, its plain version and the north-star query's phases with CUDA events
and synchronised host clocks, and prints one JSON line per phase.  The
second-to-last line lists each ported kernel; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The north-star query (NORTHSTAR_r05.json): random_sequences(100000, 10000,
# seed=0), weights 1 3 4 2, minimum.
NORTH_STAR = dict(n1=100_000, n2=10_000, seed=0, weights=(1.0, 3.0, 4.0, 2.0),
                  is_max=False)
NORTH_STAR_WINNER = (84944, 10, 10, -21596.0)

# Published H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM
# 3.35 TB/s; 67 TFLOP/s fp32 = 132 SMs x 128 fp32 lanes x 2 x 1.98 GHz.  An
# SM has half as many INT32 lanes (64), so the INT32 rate is a quarter of
# the fp32 FLOP rate; shared memory serves 32 lanes per SM per clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
SMEM_LOADS_PER_S = 132 * 32 * 1.98e9
# The least work per (offset, position) pair: one shared-memory table read
# and three integer ops (address, accumulate, max).
INT_OPS_PER_PAIR = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def sweep_bound(noff: int, n2: int, l1k: int, l2p: int, noff_pad: int):
    """(bound_ms, bound_by) of one sweep: bytes each input read once and the
    output written once over HBM, against this run's pair work over the
    INT32 and shared-memory rates."""
    pairs = float(noff) * n2
    bytes_ms = (l1k + l2p + 32 * 32 + 8 * 4 * noff_pad) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(pairs * INT_OPS_PER_PAIR / INT32_OPS_PER_S,
                 pairs / SMEM_LOADS_PER_S) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def cuda_ms(torch, fn, runs: int, warm: int = 2):
    """(median, p25, p75) device ms of fn() over `runs` runs, CUDA events
    around each run."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    q1, _, q3 = statistics.quantiles(times, n=4)
    return statistics.median(times), q1, q3


def random_codes(rng, n: int, hyphen_p: float = 0.0, other_p: float = 0.0):
    codes = rng.integers(0, 26, n).astype(np.int32)
    codes[rng.random(n) < hyphen_p] = 26
    codes[rng.random(n) < other_p] = 27
    return codes


def main() -> int:
    if not (ROOT / "psa_torch" / "csrc" / "sweep.cu").is_file():
        return fail(f"no psa_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")

    from psa_torch.core.alphabet import encode
    from psa_torch.core.tables import build_tables, device_tables
    from psa_torch.models import batch
    from psa_torch.models.search import AlignmentSearchEngine
    from psa_torch.ops import sweep as sw
    from psa_torch.utils.generator import random_sequences, write_input_file
    from psa_torch.utils.io import format_output

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
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "library": Path(lib._name).name,
          "ptxas": ptxas})

    # 3. kernel vs plain version, on the card: all 8 rows integer-equal
    # (tolerance 0: every statistic is an exact integer)
    t_ns = build_tables(np.array(NORTH_STAR["weights"]), False)
    code = torch.from_numpy(t_ns.code).to(dev)
    rng = np.random.default_rng(2024)
    cases = [("ragged", 1000, 137, 0.05, 0.0), ("bench", 131072, 8192, 0.0, 0.0),
             ("north_star", 100_000, 10_000, 0.0, 0.0),
             ("long_seq1", 400_000, 2048, 0.0, 0.0),
             ("lenient", 50_000, 3000, 0.05, 0.05)]
    max_abs = 0
    for name, n1, n2, hp, op in cases:
        c1 = random_codes(rng, n1, hp, op)
        c2 = random_codes(rng, n2, hp, op)
        noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
        d1 = sw.upload_codes(c1, l1k, dev)
        d2 = sw.upload_codes(c2, l2p, dev)
        got = sw.sweep(d1, d2, code)
        torch.cuda.synchronize()
        want = sw.sweep_plain(d1, d2, code)
        diff = int((got.long() - want.long()).abs().max().item())
        max_abs = max(max_abs, diff)
        emit({"phase": "kernel_vs_plain", "case": name, "n1": n1, "n2": n2,
              "noff_pad": noff_pad, "l2p": l2p, "max_abs_diff": diff,
              "tolerance": 0,
              "rows4_sum": int(got[:4, :noff].sum().item())})
        if diff != 0:
            return fail(f"kernel disagrees with its plain version at {name}")

    # 4. main path, end to end; the launch count is read around it only
    s1, s2 = random_sequences(NORTH_STAR["n1"], NORTH_STAR["n2"],
                              seed=NORTH_STAR["seed"])
    sw.launches = 0
    eng = AlignmentSearchEngine(NORTH_STAR["weights"], NORTH_STAR["is_max"],
                                backend="torch")
    t0 = time.perf_counter()
    res = eng.search(s1, s2)
    first_s = time.perf_counter() - t0
    got = (res.offset, res.char_offset, res.sub_code, res.score)
    emit({"phase": "north_star", "winner": list(got), "first_call_s": first_s})
    if got != NORTH_STAR_WINNER:
        return fail(f"north star winner {got} != {NORTH_STAR_WINNER}")

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
    main_launches = sw.launches
    emit({"phase": "main_path_launches", "sweep": main_launches})
    if main_launches < 1 + len(queries):
        return fail("the main path did not go through the sweep kernel")

    # 5. times on the card
    timings = {}
    for name, n1, n2 in (("bench", 131072, 8192), ("north_star", 100_000, 10_000),
                         ("long_seq1", 400_000, 2048)):
        c1 = random_codes(rng, n1)
        c2 = random_codes(rng, n2)
        noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
        d1 = sw.upload_codes(c1, l1k, dev)
        d2 = sw.upload_codes(c2, l2p, dev)
        k_ms, k_q1, k_q3 = cuda_ms(torch, lambda: sw.sweep(d1, d2, code), runs=20)
        p_ms, p_q1, p_q3 = cuda_ms(torch, lambda: sw.sweep_plain(d1, d2, code),
                                   runs=10, warm=1)
        bound_ms, bound_by = sweep_bound(noff, n2, l1k, l2p, noff_pad)
        pairs = float(noff) * n2
        timings[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        emit({"phase": "sweep_time", "case": name, "n1": n1, "n2": n2,
              "kernel_ms": k_ms, "kernel_ms_iqr": [k_q1, k_q3],
              "pair_evals_per_s": pairs / (k_ms * 1e-3),
              "plain_ms": p_ms, "plain_ms_iqr": [p_q1, p_q3],
              "bound_ms": bound_ms, "bound_by": bound_by,
              "runs": 20, "plain_runs": 10})

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
        stats5 = sw.stats5_from_sweep(sw.sweep(d1, d2, dtabs.code))
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
    emit({"phase": "north_star_split_ms", **e2e, "runs": len(split["total"])})

    # the same query through the engine, unsynchronised between phases, and
    # one traced run for the device's busy time
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.search(s1, s2)
        walls.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.search(s1, s2)
        traced_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the operator
    # entries on the host side repeat their kernels' time
    dev_us = {ev.key: ev.self_device_time_total for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and ev.self_device_time_total > 0}
    busy_ms = sum(dev_us.values()) / 1e3
    emit({"phase": "north_star_engine_ms", "median": statistics.median(walls),
          "min": min(walls), "max": max(walls), "runs": len(walls),
          "traced_ms": traced_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else None,
          "device_idle_share": 1 - busy_ms / traced_ms if busy_ms > 0 else None,
          "device_top": sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]})

    # 6. the ported kernels
    print(smi_line, flush=True)
    emit({"kernels": [{
        "name": "sweep", "route": "cuda", "source": "psa_torch/csrc/sweep.cu",
        "replaces": "psa_tpu/ops/pallas_sweep.py:297",
        "launches": main_launches, "max_abs_err": max_abs,
        "max_abs_diff": max_abs, "shape": "100000x10000",
        **timings["north_star"], "library_ms": None}]})
    # 7. last line
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
