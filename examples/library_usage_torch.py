"""Library quickstart: the public surfaces of psa_torch, the PyTorch/CUDA
port.

Run: python examples/library_usage_torch.py     (seconds; on the card when
there is one, else on the CPU, which it says; from a checkout, installed
or not)

The counterpart of examples/library_usage.py: the single query, the batch
(`search_batch`) and the sharded searches, with the same queries.  Reference
workflow analog: main.c:13-56 (read input -> search -> write), but as a
library; the reference has no importable API at all.  Imports neither JAX
nor the JAX package.
"""

import sys
from pathlib import Path

import numpy as np
import torch

WEIGHTS = np.array([1.0, 3.0, 4.0, 2.0])


def pick_device() -> str:
    """The card when there is one, else the CPU (the kernels' plain PyTorch
    versions).  The library never picks the CPU by itself: without a card
    its entry points raise unless they are given device="cpu"."""
    if torch.cuda.is_available():
        return "cuda"
    print("no CUDA device: running on the CPU (the kernels' plain versions)")
    return "cpu"


def mesh_of(device: str, n: int = 4) -> list:
    """A 1-D mesh of n shards: every card, or n shards of the one CPU
    device (entries may repeat)."""
    from psa_torch.parallel.mesh import make_mesh

    return make_mesh(None if device == "cuda" else ["cpu"] * n)


def single_query(device: str):
    """One (Seq1, Seq2) search with the reference's exact semantics."""
    from psa_torch import AlignmentSearchEngine
    from psa_torch.utils.generator import random_sequences

    seq1, seq2 = random_sequences(5_000, 800, seed=0)
    # weights = (w1, w2, w3, w4); False = minimum mode ("maximum" -> True)
    engine = AlignmentSearchEngine(WEIGHTS, is_max=False, backend="torch",
                                   device=device)
    res = engine.search(seq1, seq2)
    print(f"single: offset={res.offset} char_offset={res.char_offset} "
          f"substitute={res.sub_char} score={res.score:g}")
    print(f"        mutant[:40] = {res.mutant(seq2)[:40]}...")
    return res


def batch_queries() -> list:
    from psa_torch import Query
    from psa_torch.utils.generator import random_sequences

    queries = []
    for seed, (n1, n2) in enumerate([(3_000, 500), (3_000, 500),
                                     (1_200, 200)]):
        s1, s2 = random_sequences(n1, n2, seed=seed)
        queries.append(Query(weights=WEIGHTS, seq1=s1, seq2=s2, is_max=False))
    return queries


def batch_serving(device: str) -> list:
    """Many queries at once: bucketed by shape, streamed in microbatches."""
    from psa_torch import search_batch

    results = search_batch(batch_queries(), backend="torch", device=device)
    for i, r in enumerate(results):
        print(f"batch[{i}]: offset={r.offset} score={r.score:g}"
              if r else f"batch[{i}]: no mutation")
    return results


def sharded(device: str):
    """Offset axis sharded over the mesh (the analog of the reference's MPI
    split, cpu_funcs.c:128-133)."""
    from psa_torch import build_tables, encode
    from psa_torch.parallel.mesh import search_sharded
    from psa_torch.utils.generator import random_sequences

    seq1, seq2 = random_sequences(20_000, 2_000, seed=1)
    mesh = mesh_of(device)
    res = search_sharded(encode(seq1), encode(seq2),
                         build_tables(WEIGHTS, False), mesh)
    print(f"sharded ({len(mesh)} shards): offset={res.offset} "
          f"score={res.score:g}")
    return res


def sharded_auto_2d(device: str):
    """Workload-aware mesh shape: a char axis when it pays (counts summed
    and ranks maxed over Seq2 chunks, exact), else offset shards.  What the
    CLI's --sharded flag routes through."""
    from psa_torch import build_tables, encode
    from psa_torch.parallel.mesh import mesh_shape, search_sharded_auto
    from psa_torch.utils.generator import random_sequences

    seq1, seq2 = random_sequences(6_000, 2_000, seed=2)
    mesh = mesh_of(device)
    shape = mesh_shape(len(mesh), len(seq1) - len(seq2) + 1, len(seq2))
    res = search_sharded_auto(encode(seq1), encode(seq2),
                              build_tables(WEIGHTS, False), mesh)
    print(f"sharded-auto (mesh {shape[0]}x{shape[1]} op x ch): "
          f"offset={res.offset} score={res.score:g}")
    return res


def sharded_batch_queries():
    from psa_torch import encode
    from psa_torch.core.alphabet import pad_codes
    from psa_torch.utils.generator import random_sequences

    n1, n2, l2p = 1_000, 120, 128
    l1k = 1024 + l2p
    c1b, c2b = [], []
    for seed in range(6):
        s1, s2 = random_sequences(n1, n2, seed=seed)
        c1b.append(pad_codes(encode(s1), l1k))
        c2b.append(pad_codes(encode(s2), l2p))
    b = len(c1b)
    return (np.stack(c1b), np.stack(c2b), np.full(b, n1 - n2 + 1, np.int32),
            np.full(b, n2, np.int32))


def sharded_batch_serving(device: str) -> list:
    """Query axis sharded over the mesh: each shard sweeps its own block of
    queries (nothing crosses devices), selection stays bit-exact."""
    from psa_torch import build_tables
    from psa_torch.models.batch import batched_search_exact_sharded

    mesh = mesh_of(device)
    results = batched_search_exact_sharded(*sharded_batch_queries(),
                                           build_tables(WEIGHTS, False), mesh)
    print(f"sharded batch ({len(mesh)} shards): "
          + " ".join(f"{r.offset}" for r in results))
    return results


def main() -> None:
    device = pick_device()
    single_query(device)
    batch_serving(device)
    sharded(device)
    sharded_auto_2d(device)
    sharded_batch_serving(device)


if __name__ == "__main__":
    # the checkout's package, where `pip install -e .` has not been run
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    main()
