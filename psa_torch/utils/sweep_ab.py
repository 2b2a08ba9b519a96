"""Time the offset sweeps (`sweep`, `sweep_batched`, `sweep_batched_shared`)
of several checkouts of the port in turns on one card.

    python -m psa_torch.utils.sweep_ab TREE [TREE ...]

Each TREE is a directory that holds a `psa_torch` package (`.` for this
checkout; another commit's package can be unpacked beside it with `git
archive <commit> psa_torch | tar -x -C DIR`).  The trees run in the order
given (parent, change, change, parent compares two), each in a process of
its own that imports TREE's `psa_torch` and builds TREE's library.  Each
run times, at the benchmark cells' 600,000 x 250,000 (uniform letters,
seed 24, weights 1 3 4 2, minimum), `sweep` and both batched kernels at
B = 1, 4 and 8, and at the batch workload's 1,024 queries of 2,048 x 512
(`plan_bucket`'s padding) both batched kernels, BACK_TO_BACK launches a
pair of CUDA events there; every time is the median of RUNS pairs
(`kernel_lab.cuda_ms`, this checkout's, loaded from its file so that two
packages never meet in one process).  A digest of every output lets the
summary check that the trees agree bit for bit.  Each run prints one JSON
line (the card, its power limit, the tree, ms and digests); the last line
gives each tree's median ms per kernel and shape over its runs and whether
all digests agree.  Exits 1 if they differ or a run fails, 2 without a
card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

CELL = (600_000, 250_000)
SMALL = (1024, 2048, 512)
BATCHES = (1, 4, 8)
RUNS = 5
BACK_TO_BACK = 10
SEED = 24


def this_kernel_lab():
    """This checkout's `kernel_lab`, loaded from its file: it imports nothing
    of `psa_torch` at load time."""
    spec = importlib.util.spec_from_file_location(
        "sweep_ab_kernel_lab", Path(__file__).with_name("kernel_lab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def child(tree: str) -> dict:
    """One run of TREE's sweeps: {"ms": {name: median ms}, "digest": {...}}."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from psa_torch.core.tables import build_tables
    from psa_torch.ops import sweep as sw

    cuda_ms = this_kernel_lab().cuda_ms
    dev = torch.device("cuda")
    sw.build_library()
    code = torch.from_numpy(build_tables(np.array([1.0, 3.0, 4.0, 2.0]),
                                         False).code).to(dev)
    rng = np.random.default_rng(SEED)
    ms, dig = {}, {}

    def rows(b, n1, n2):
        l2p = sw.plan_shapes(n1, n2)[2]
        _, l1k = sw.plan_bucket([n1 - n2 + 1], l2p)
        c1 = np.full((b, l1k), 28, np.uint8)
        c2 = np.full((b, l2p), 28, np.uint8)
        c1[:, :n1] = rng.integers(0, 26, (b, n1))
        c2[:, :n2] = rng.integers(0, 26, (b, n2))
        return torch.from_numpy(c1).to(dev), torch.from_numpy(c2).to(dev)

    def timed(name, fn, back_to_back=1):
        dig[name] = digest(fn())

        def many():
            for _ in range(back_to_back):
                fn()
        ms[name] = cuda_ms(torch, many, runs=RUNS)[0] / back_to_back

    d1, d2 = rows(max(BATCHES), *CELL)
    timed("sweep", lambda: sw.sweep(d1[0], d2[0], code))
    for b in BATCHES:
        timed(f"batched_b{b}", lambda: sw.sweep_batched(d1[:b], d2[:b], code))
        timed(f"shared_b{b}", lambda: sw.sweep_batched_shared(d1[0], d2[:b], code))
    del d1, d2
    s1, s2 = rows(*SMALL)
    timed("batched_small", lambda: sw.sweep_batched(s1, s2, code), BACK_TO_BACK)
    timed("shared_small", lambda: sw.sweep_batched_shared(s1[0], s2, code),
          BACK_TO_BACK)
    return {"ms": ms, "digest": dig,
            "small_noff_pad": int(s1.shape[1] - s2.shape[1])}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    tool = shutil.which("nvidia-smi")
    smi = tool and subprocess.run([tool, "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True)
    if not smi or smi.returncode != 0:
        print("sweep_ab: no card", file=sys.stderr)
        return 2
    runs, failed = [], False
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--child", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            failed = True
            continue
        line = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                    tree=tree, card=smi.stdout.strip())
        print(json.dumps(line), flush=True)
        runs.append(line)
    trees = {}
    for r in runs:
        for name, v in r["ms"].items():
            trees.setdefault(r["tree"], {}).setdefault(name, []).append(v)
    agree = len({json.dumps(r["digest"], sort_keys=True) for r in runs}) <= 1
    print(json.dumps({"summary": {t: {k: statistics.median(v) for k, v in d.items()}
                                  for t, d in trees.items()},
                      "digests_agree": agree, "runs": len(runs)}), flush=True)
    return 1 if failed or not agree else 0


if __name__ == "__main__":
    sys.exit(main())
