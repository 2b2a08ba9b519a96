"""Time the top-k epilogue kernel (csrc/epilogue.cu) of several checkouts of
the port in turns on one card, and split each call into host and device.

    python -m psa_torch.utils.epilogue_ab TREE [TREE ...]
    python -m psa_torch.utils.epilogue_ab --phases TREE [TREE ...]
    python -m psa_torch.utils.epilogue_ab --paths TREE [TREE ...]

Each TREE is a directory that holds a `psa_torch` package (`.` for this
checkout; another commit's can be unpacked beside it with `git archive
<commit> psa_torch | tar -x -C DIR`).  The trees run in the order given
(parent, change, change, parent compares two), each in a process of its own
that imports TREE's `psa_torch`, builds TREE's library and, on the stats5
of each of CASES (made by TREE's sweeps from seeded codes), holds TREE's
`epilogue_pack` against TREE's `epilogue_pack_plain` (word for word, and
under TREE's `pack_mismatch`: `same_set` where the two differ at most in
the order of equal keys) and measures it:
- `ms` and `ms_back_to_back`: CUDA events around one call, and around
  BACK_TO_BACK calls, the median of RUNS (`kernel_lab.cuda_ms`);
- `host_us`: the wrapper's host time per call, `time.perf_counter` around
  the call with no synchronise, warm, the median of HOST_CALLS;
- `device_us`: the profiler's device time of the epilogue kernels per call
  (`torch.profiler`, one profile over every case, PROFILE_CALLS calls each)
  and their number per call;
- `cuda_launches_per_call`: the wrapper's own count.
Beside them each run gives the launch floor, a one-element `fill_` on the
same stream timed by the same three methods, the host µs of some of the
wrapper's steps alone (`host_parts_us`), and per case the blocks of a
wide row whose largest key lies in the band below the row's best (the only
blocks whose keys the row's last block counts again).  Prints one JSON line
per run and a summary last; exits 1 if a kernel's pack holds other keys
than its plain version's or a run fails, 2 without a card.

With --phases each TREE's kernel is built once more with PSA_EPILOGUE_PHASES
defined, in a temporary copy of its package, which makes its blocks stamp
%globaltimer and clock64 at each phase (csrc/epilogue.cu `mark`); one warm
call per case then gives each phase's cycles per block (median and most)
and the call's timeline in ns, one JSON line per TREE.

With --paths each TREE runs the paths the epilogue is on (`run_paths`): the
north-star query's phases and engine, sharded north stars and batch
dispatches, host-clock medians, one JSON line per TREE in the order given.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# name -> (rows, n1, n2, seed): one query's stats5 from `sweep` where rows
# is 1, else `rows` queries' from `sweep_batched`; all_A is every code 0.
CASES = {"north_star": (1, 100_000, 10_000, 0),
         "batch": (1024, 2048, 512, 99),
         "seq1_1M": (1, 1_000_000, 2048, 1),
         "all_A": (1, 200_000, 2048, None)}
WEIGHTS = (1.0, 3.0, 4.0, 2.0)
RUNS = 30
BACK_TO_BACK = 10
HOST_CALLS = 400
PROFILE_CALLS = 20


def this_kernel_lab():
    """This checkout's `kernel_lab` (its timer), loaded from its file: it
    imports nothing of `psa_torch` at load time."""
    spec = importlib.util.spec_from_file_location(
        "epilogue_ab_kernel_lab", Path(__file__).with_name("kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Median host µs of one warm call of fn(), unsynchronised; the stream
    is drained every 16 calls, outside the timed calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 16 == 15:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


# Seconds of idle between two profiled ranges: device timestamps can lie a
# little off the host's, so each device event goes to the nearest range.
RANGE_GAP_S = 0.05


def device_events(prof, ranges: list[str], cats=("kernel", "gpu_memcpy", "gpu_memset")):
    """{range: {"cat: name": [count, device µs]}} of a finished profile: each
    device event of the categories `cats` is put in the `record_function`
    range nearest its midpoint (the one that holds it, else the closest
    end).  Each range ends in a synchronise and RANGE_GAP_S of idle, so a
    device clock a few ms off the host's still finds the right range."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in ranges]
    out = {name: {} for name in ranges}
    for e in events:
        if e.get("cat") not in cats or not spans:
            continue
        mid = e["ts"] + e["dur"] / 2
        r = min(spans, key=lambda r: max(r["ts"] - mid, mid - r["ts"] - r["dur"], 0))
        rec = out[r["name"]].setdefault(f"{e['cat']}: {e['name']}", [0, 0.0])
        rec[0] += 1
        rec[1] += e["dur"]
    return out


def case_stats(torch, sw, code, case: str, dev):
    """(stats5 (B, 5, NP) on the card, noff (int or (B,) int32 tensor),
    l2p) of one of CASES."""
    import numpy as np

    rows, n1, n2, seed = CASES[case]
    rng = np.random.default_rng(seed)
    noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
    if rows == 1:
        c1 = rng.integers(0, 26, n1) if seed is not None else np.zeros(n1, np.int64)
        c2 = rng.integers(0, 26, n2) if seed is not None else np.zeros(n2, np.int64)
        d1, d2 = sw.upload_codes(dev, (c1, l1k), (c2, l2p))
        return sw.sweep(d1, d2, code)[None], noff, l2p
    _, l1b = sw.plan_bucket([noff] * rows, l2p)
    c1b = np.full((rows, l1b), 28, np.uint8)
    c1b[:, :n1] = rng.integers(0, 26, (rows, n1))
    c2b = rng.integers(0, 26, (rows, l2p)).astype(np.uint8)
    c2b[:, n2:] = 28
    stats5 = sw.sweep_batched(torch.from_numpy(c1b).to(dev),
                              torch.from_numpy(c2b).to(dev), code)
    return stats5, torch.full((rows,), noff, dtype=torch.int32, device=dev), l2p


def band_blocks(torch, stats5, dtabs, noff, l2p, block_cols: int) -> int:
    """Blocks of block_cols offsets, over all rows wider than one block,
    whose largest key lies in [best - eps, best) of their row."""
    from psa_torch.ops.common import keyed_f32_totals_ops

    np_ = stats5.shape[2]
    if np_ <= block_cols:
        return 0
    keyed, _ = keyed_f32_totals_ops(stats5[:, :4], stats5[:, 4], dtabs.w32,
                                    dtabs.diff32, dtabs.is_max, noff)
    pad = -np_ % block_cols
    blocks = torch.nn.functional.pad(keyed, (0, pad), value=float("-inf"))
    bmax = blocks.view(keyed.shape[0], -1, block_cols).amax(-1)
    best = keyed.amax(-1, keepdim=True)
    return int(((bmax < best) & (bmax >= best - dtabs.eps(l2p))).sum().item())


def epilogue_registers(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} of the epilogue
    kernels in nvcc's `-Xptxas -v` output."""
    import re

    return {m.group(1): (int(m.group(3)), int(m.group(2))) for m in re.finditer(
        r"Compiling entry function '(\S*epilogue\S*)'.*?(\d+) bytes spill stores.*?"
        r"Used (\d+) registers", log, re.S)}


def run_tree(tree: str) -> dict:
    """Measure the epilogue of the `psa_torch` under `tree` (run as a
    script, so that no `psa_torch` is imported before `tree`'s)."""
    lab = this_kernel_lab()
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from psa_torch.core.tables import build_tables, device_tables
    from psa_torch.ops import epilogue as ep
    from psa_torch.ops import sweep as sw

    if not Path(ep.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"psa_torch imported from {ep.__file__}, not {root}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = sw.build_library()
    build_s = time.perf_counter() - t0
    log = Path(lib._name).with_suffix(".log")
    dtabs = device_tables(build_tables(np.array(WEIGHTS), False), dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def block_cols(np_: int) -> int:  # the tree's width of a wide row's blocks
        return ep.block_cols(np_, sms) if hasattr(ep, "block_cols") else getattr(
            ep, "BLOCK_COLS", ep.EPILOGUE_COLS)
    inputs = {case: case_stats(torch, sw, dtabs.code, case, dev) for case in CASES}
    one = torch.zeros(1, device=dev)
    floor = {"ms": lab.cuda_ms(torch, lambda: one.fill_(1.0), RUNS)[0],
             "ms_back_to_back": lab.cuda_ms(torch, lambda: one.fill_(1.0), RUNS,
                                            back_to_back=BACK_TO_BACK)[0],
             "host_us": host_us(torch, lambda: one.fill_(1.0))}
    stats5, noff, l2p = inputs["north_star"]
    parts = {"empty_out": lambda: torch.empty((1, 6 * ep.TOPK + 2), dtype=torch.int32,
                                              device=dev),
             "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
             "current_device": torch.cuda.current_device,
             "eps": lambda: dtabs.eps(l2p),
             "build_library": sw.build_library}
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "build_s": build_s,
           "registers": epilogue_registers(log.read_text() if log.exists() else ""),
           "launch_floor": floor, "host_parts_us": {name: host_us(torch, fn)
                                                    for name, fn in parts.items()},
           "cases": {}}
    for case, (stats5, noff, l2p) in inputs.items():
        def call():
            return ep.epilogue_pack(stats5, dtabs, noff, l2p)

        before = ep.cuda_launches
        got = call()
        launched = ep.cuda_launches - before
        want = ep.epilogue_pack_plain(stats5, dtabs, noff, l2p)
        torch.cuda.synchronize()
        mismatch = ep.pack_mismatch(want, got, stats5, noff, dtabs)
        repeat = torch.equal(call(), got)
        ms = lab.cuda_ms(torch, call, RUNS)
        bb = lab.cuda_ms(torch, call, RUNS, back_to_back=BACK_TO_BACK)
        out["cases"][case] = {
            "rows": stats5.shape[0], "np": stats5.shape[2],
            "equal": bool(torch.equal(got, want)), "mismatch": mismatch,
            "same_set": mismatch is None or mismatch.endswith("another order)"),
            "equal_on_repeat": repeat, "cuda_launches_per_call": launched,
            "near": int(got[0, 6 * ep.TOPK].item()),
            "block_cols": block_cols(stats5.shape[2]),
            "band_blocks": band_blocks(torch, stats5, dtabs, noff, l2p,
                                       block_cols(stats5.shape[2])),
            "ms": ms[0], "ms_iqr": list(ms[1:]), "ms_back_to_back": bb[0],
            "back_to_back_iqr": list(bb[1:]), "host_us": host_us(torch, call)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for case, (stats5, noff, l2p) in inputs.items():
            with record_function(case):
                for _ in range(PROFILE_CALLS):
                    ep.epilogue_pack(stats5, dtabs, noff, l2p)
                torch.cuda.synchronize()
            time.sleep(RANGE_GAP_S)
    for case, evs in device_events(prof, list(CASES), cats=("kernel",)).items():
        kern = [v for name, v in evs.items() if "epilogue" in name]
        out["cases"][case]["device_us"] = sum(v[1] for v in kern) / PROFILE_CALLS
        out["cases"][case]["kernels_per_call"] = sum(v[0] for v in kern) / PROFILE_CALLS
    return out


def phase_summary(ns, clk, multi: bool) -> dict:
    """The phase marks of one call (kernel's `mark`: (slots, 8) %globaltimer
    ns and clock64) as medians and maxima of each block's phases in cycles
    and the call's timeline in ns from the first block's entry."""
    import numpy as np

    used = ns[:, 0] != 0
    ns, clk = ns[used].astype(np.int64), clk[used]
    t0 = ns[:, 0].min()
    spans = {"keys": (0, 1), "top": (1, 2), "band_count": (2, 3)}
    spans.update({"publish_and_ticket": (3, 4)} if multi else {"pack": (3, 7)})
    out = {"blocks": int(used.sum())}
    for name, (i, j) in spans.items():
        d = clk[:, j] - clk[:, i]
        out[f"{name}_cycles"] = [int(np.median(d)), int(d.max())]
    out["entry_spread_ns"] = int(ns[:, 0].max() - t0)
    if multi:
        last = np.flatnonzero(ns[:, 5] != 0)
        if last.size != 1:
            return {**out, "error": f"{last.size} last blocks"}
        lb = last[0]
        out["all_ticketed_ns"] = int(ns[:, 4].max() - t0)
        out["last_block_entry_ns"] = int(ns[lb, 0] - t0)
        for name, (i, j) in {"best_and_near": (4, 5), "candidates_top": (5, 6),
                             "pack": (6, 7)}.items():
            out[f"last_{name}_cycles"] = int(clk[lb, j] - clk[lb, i])
        out["end_ns"] = int(ns[lb, 7] - t0)
    else:
        out["end_ns"] = int(ns[:, 7].max() - t0)
    return out


def run_phases(tree: str) -> dict:
    """The phase marks of TREE's kernel at each of CASES: TREE's package is
    copied to a temporary directory with PSA_EPILOGUE_PHASES defined at the
    head of csrc/epilogue.cu, built there and called once, warm, per case
    (run as a script, like `run_tree`)."""
    import ctypes
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="epilogue_phases_"))
    try:
        shutil.copytree(Path(tree).resolve() / "psa_torch", tmp / "psa_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = tmp / "psa_torch" / "csrc" / "epilogue.cu"
        src.write_text("#define PSA_EPILOGUE_PHASES 1\n" + src.read_text())
        sys.path.insert(0, str(tmp))
        import numpy as np
        import torch

        from psa_torch.core.tables import build_tables, device_tables
        from psa_torch.ops import epilogue as ep
        from psa_torch.ops import sweep as sw

        lib = sw.build_library()
        fn = lib.psa_epilogue_phases
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        slots = 2048
        ns = np.zeros((slots, 8), np.uint64)
        clk = np.zeros((slots, 8), np.int64)
        dev = torch.device("cuda")
        dtabs = device_tables(build_tables(np.array(WEIGHTS), False), dev)
        out = {"tree": tree, "device": torch.cuda.get_device_name(0), "cases": {}}
        for case in CASES:
            stats5, noff, l2p = case_stats(torch, sw, dtabs.code, case, dev)
            for _ in range(3):
                ep.epilogue_pack(stats5, dtabs, noff, l2p)
            if fn(ns.ctypes.data, clk.ctypes.data) != slots:
                raise RuntimeError("psa_epilogue_phases failed")
            ep.epilogue_pack(stats5, dtabs, noff, l2p)
            if fn(ns.ctypes.data, clk.ctypes.data) != slots:
                raise RuntimeError("psa_epilogue_phases failed")
            out["cases"][case] = phase_summary(ns, clk, stats5.shape[2] > ep.EPILOGUE_COLS)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_paths(tree: str, device: str = "cuda", north_star=(100_000, 10_000),
              query=(2048, 512)) -> dict:
    """Host-clock medians of the paths the epilogue runs on, with TREE's
    `psa_torch` (run as a script, like `run_tree`): the north-star query's
    phases synchronised one by one (upload, sweep, epilogue, fetch, host
    selection) and unsynchronised through the engine; the north star on
    meshes of 1, 4 and 8 shards of the card and of 2 x 2; and the dispatch
    and finish of `search_batch_async` on 8 and 256 queries of the batch
    workload's shape (`query`).  Every winner is checked against the
    first.  Another `device` and smaller shapes rehearse it on the CPU."""
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from psa_torch.core.alphabet import encode
    from psa_torch.core.tables import device_tables
    from psa_torch.models import batch
    from psa_torch.models.search import AlignmentSearchEngine
    from psa_torch.ops import epilogue as ep
    from psa_torch.ops import sweep as sw
    from psa_torch.parallel import mesh
    from psa_torch.utils.generator import random_sequences
    from psa_torch.utils.io import Query

    if not Path(ep.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"psa_torch imported from {ep.__file__}, not {root}")
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    s1, s2 = random_sequences(*north_star, seed=0)
    eng = AlignmentSearchEngine(WEIGHTS, False, device=dev)
    want = eng.search(s1, s2)
    c1, c2 = encode(s1), encode(s2)
    noff, _, l2p, l1k = sw.plan_shapes(c1.shape[0], c2.shape[0])
    dtabs = device_tables(eng.tables, dev)

    def timed(fn, runs: int, warm: int = 2) -> float:
        for _ in range(warm):
            fn()
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3

    split = {k: [] for k in ("upload", "sweep", "epilogue", "fetch", "host_select")}
    for it in range(12):
        sync()
        t = [time.perf_counter()]
        d1, d2 = sw.upload_codes(dev, (c1, l1k), (c2, l2p))
        sync()
        t.append(time.perf_counter())
        stats5 = sw.sweep(d1, d2, dtabs.code)
        sync()
        t.append(time.perf_counter())
        packed = ep.epilogue_pack(stats5[None], dtabs, noff, l2p)
        sync()
        t.append(time.perf_counter())
        buf = packed.cpu().numpy()
        t.append(time.perf_counter())
        r = batch.host_select(c1, c2, noff, eng.tables, buf, stats5)
        t.append(time.perf_counter())
        if r != want:
            raise RuntimeError("the north star's winner changed")
        if it >= 2:
            for name, a, b in zip(split, t, t[1:]):
                split[name].append((b - a) * 1e3)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu", "north_star_split_ms": {k: statistics.median(v) for k, v in split.items()},
           "north_star_engine_ms": timed(lambda: eng.search(s1, s2), 10), "sharded_ms": {}}
    meshes = {str(n): [dev] * n for n in (1, 4, 8)}
    meshes["2x2"] = mesh.make_mesh_2d([dev] * 4, 2, 2)
    for name, m in meshes.items():
        fn = ((lambda m=m: mesh.search_sharded_2d(c1, c2, eng.tables, m)) if name == "2x2"
              else (lambda m=m: mesh.search_sharded(c1, c2, eng.tables, m)))
        if fn() != want:
            raise RuntimeError(f"the north star on mesh {name} changed")
        out["sharded_ms"][name] = timed(fn, 7)
    qs = [Query(np.array(WEIGHTS), *random_sequences(*query, seed=q), False)
          for q in range(256)]
    for n in (8, 256):
        ph = {"dispatch": [], "finish": []}
        for it in range(9):
            t0 = time.perf_counter()
            _, fin = batch.search_batch_async(qs[:n], backend="torch", device=dev)
            t1 = time.perf_counter()
            fin()
            t2 = time.perf_counter()
            if it >= 2:
                ph["dispatch"].append((t1 - t0) * 1e3)
                ph["finish"].append((t2 - t1) * 1e3)
        out[f"chunk_{n}_ms"] = {k: statistics.median(v) for k, v in ph.items()}
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--run"]:
        print(json.dumps(run_tree(argv[1])), flush=True)
        return 0
    if argv[:1] == ["--run-phases"]:
        print(json.dumps(run_phases(argv[1])), flush=True)
        return 0
    if argv[:1] == ["--run-paths"]:
        print(json.dumps(run_paths(argv[1])), flush=True)
        return 0
    if not argv or (argv[0].startswith("-") and argv[0] not in ("--phases", "--paths")):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("epilogue_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"nvidia_smi": smi.stdout.strip()}), flush=True)
    if argv[0] in ("--phases", "--paths"):
        ok = True
        for tree in argv[1:]:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--run-" + argv[0][2:], tree],
                                  stdout=subprocess.PIPE, text=True, timeout=600)
            lines = proc.stdout.strip().splitlines()
            ok &= proc.returncode == 0 and bool(lines)
            print(lines[-1] if lines else json.dumps({"tree": tree, "rc": proc.returncode}),
                  flush=True)
        return 0 if ok else 1
    keys = ("ms", "ms_back_to_back", "host_us", "device_us")
    summary, ok = {}, True
    for i, tree in enumerate(argv):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", tree],
                              stdout=subprocess.PIPE, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(json.dumps({"run": i, "tree": tree, "rc": proc.returncode}), flush=True)
            ok = False
            continue
        res = json.loads(lines[-1])
        print(json.dumps({"run": i, **res}), flush=True)
        per_tree = summary.setdefault(tree, {})
        for name, t in (("launch_floor", res["launch_floor"]), *res["cases"].items()):
            ok &= t.get("same_set", True)
            rec = per_tree.setdefault(name, {k: [] for k in keys})
            for k in keys:
                if k in t:
                    rec[k].append(t[k])
    print(json.dumps({"ok": ok, "summary": summary}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
