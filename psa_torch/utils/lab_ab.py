"""Time the kernel lab's tensor-core sweeps of several checkouts of the port
in turns on one card.

    python -m psa_torch.utils.lab_ab TREE [TREE ...]

Each TREE is a directory that holds a `psa_torch` package (`.` for this
checkout; another commit's package can be unpacked beside it with `git
archive <commit> psa_torch | tar -x -C DIR`).  The trees run in the order
given (parent, change, change, parent compares two), each in a process of
its own that imports TREE's `psa_torch`, builds TREE's library and, at each
of SHAPES (clean random codes, seed 7), holds TREE's `sweep_v2` and
`sweep_v3` against TREE's plain versions (tolerance 0: exact integers) and
times them: one launch per pair of CUDA events, and BACK_TO_BACK launches
per pair, the median of RUNS each.  The timer (`cuda_ms`), the SASS reader
(`sass_loop_mix`) and `dispatch_ms` are this checkout's `kernel_lab`, the
ones chip_smoke.py reports with, loaded from its file so that both
packages never meet in one process; `dispatch_ms` reads the main loops of
the kernels named in COMPILED, and is null for a tree whose kernels carry
other names.  Each run prints one JSON line with the SASS loop mix of
every kernel in TREE's library; the last line sums the times up per tree.
Exits 1 if a kernel disagrees with its plain version or a run fails, 2
without a card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

# bench: the lab's shape; north_star: the single-query path's; one_segment:
# a shape where v3's split puts one Seq2 segment on each tile.
SHAPES = {"bench": (131_072, 8192), "north_star": (100_000, 10_000),
          "one_segment": (1_000_000, 500)}
RUNS = 20
BACK_TO_BACK = 10
# The lab's kernels by their compiled names (kernel_lab.LOOP_PAIRS).
COMPILED = {"sweep_v2": "sweep_mma_kernel", "sweep_v3": "sweep_v3_kernel"}


def this_kernel_lab():
    """This checkout's `kernel_lab`, loaded from its file: it imports nothing
    of `psa_torch` at load time."""
    spec = importlib.util.spec_from_file_location(
        "lab_ab_kernel_lab", Path(__file__).with_name("kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_tree(tree: str) -> dict:
    """Measure the lab kernels of the `psa_torch` under `tree` (run as a
    script, so that no `psa_torch` is imported before `tree`'s)."""
    lab = this_kernel_lab()
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from psa_torch.ops import _sweep_v2 as v2
    from psa_torch.ops import _sweep_v3 as v3
    from psa_torch.ops import sweep as sw

    if not Path(sw.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"psa_torch imported from {sw.__file__}, not {root}")
    sass = lab.sass_loop_mix(lab.sass_of(sw.build_library()._name))
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "sass": sass,
           "times": {}}
    code = torch.from_numpy(lab.lab_inputs(64, 64)[0].code).cuda()
    rng = np.random.default_rng(7)
    for shape, (n1, n2) in SHAPES.items():
        noff, noff_pad, l2p, l1k = v2.plan_shapes_v2(n1, n2)
        d1 = sw.upload_codes(rng.integers(0, 26, n1), l1k, "cuda")
        d2 = sw.upload_codes(rng.integers(0, 26, n2), l2p, "cuda")
        for kernel, fn, plain in (("sweep_v2", v2.sweep_v2, v2.sweep_v2_plain),
                                  ("sweep_v3", v3.sweep_v3, v3.sweep_v3_plain)):
            got = fn(d1, d2, code)
            torch.cuda.synchronize()
            diff = int((got.long() - plain(d1, d2, code).long()).abs().max().item())
            one = lab.cuda_ms(torch, lambda: fn(d1, d2, code), RUNS)
            bb = lab.cuda_ms(torch, lambda: fn(d1, d2, code), RUNS,
                             back_to_back=BACK_TO_BACK)
            out["times"].setdefault(kernel, {})[shape] = {
                "n1": n1, "n2": n2, "max_abs_diff": diff, "ms": one[0],
                "ms_iqr": one[1:], "ms_back_to_back": bb[0],
                "back_to_back_iqr": bb[1:],
                "dispatch_ms": lab.dispatch_ms(sass, COMPILED[kernel], float(noff) * n2)}
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--run"]:
        print(json.dumps(run_tree(argv[1])), flush=True)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("lab_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"nvidia_smi": smi.stdout.strip()}), flush=True)
    summary, ok = {}, True
    for i, tree in enumerate(argv):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", tree],
                              stdout=subprocess.PIPE, text=True, timeout=900)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(json.dumps({"run": i, "tree": tree, "rc": proc.returncode}), flush=True)
            ok = False
            continue
        res = json.loads(lines[-1])
        print(json.dumps({"run": i, **res}), flush=True)
        per_tree = summary.setdefault(tree, {})
        for kernel, shapes in res["times"].items():
            for shape, t in shapes.items():
                ok &= t["max_abs_diff"] == 0
                rec = per_tree.setdefault(f"{kernel} {shape}", {"ms": [], "ms_back_to_back": []})
                rec["ms"].append(t["ms"])
                rec["ms_back_to_back"].append(t["ms_back_to_back"])
        for kernel, name in COMPILED.items():
            per_tree[f"{kernel} per_pair"] = res["sass"].get(name, {}).get("per_pair")
    print(json.dumps({"ok": ok, "summary": summary}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
