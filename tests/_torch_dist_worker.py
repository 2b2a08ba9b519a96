"""One rank of the two-process test of psa_torch.parallel.multihost's
exchanges (tests/test_torch_multihost.py).

    python tests/_torch_dist_worker.py <rank> <world> <port> <cases file>

Rank 0 reads the cases; every rank joins the Gloo group, receives the
query and the case list by broadcast (rank != 0 never sees the file) and
gathers one row per rank; each prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from psa_torch.parallel import multihost  # noqa: E402
from psa_torch.parallel.mesh import _gather_rows, process_layout  # noqa: E402
from psa_torch.utils.io import read_cases  # noqa: E402

rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
multihost.initialize(f"127.0.0.1:{port}", world, rank)
try:
    assert process_layout() == (world, rank)
    cases = read_cases(path) if rank == 0 else None
    got = multihost.broadcast_cases(cases)
    w, c1, c2, is_max = multihost.broadcast_query(cases[0] if rank == 0 else None)
    rows = _gather_rows(torch.full((1, 3), rank, dtype=torch.int32))
    print(json.dumps({
        "rank": rank, "primary": multihost.is_primary(),
        "cases": [[list(map(float, q.weights)), q.seq1, q.seq2, q.is_max] for q in got],
        "query": [list(map(float, w)), c1.tolist(), c2.tolist(), is_max],
        "gathered": rows[:, 0].tolist()}), flush=True)
finally:
    multihost.shutdown()
