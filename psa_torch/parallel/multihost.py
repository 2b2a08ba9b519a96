"""Multi-process search over a torch.distributed group: the port of the
JAX package's parallel/multihost.py.

The reference's MPI process layer (main.c:20-22, cpu_funcs.c:51) becomes a
Gloo process group: process 0 reads and validates the input, a status
broadcast goes out before any payload (so a bad file fails every rank
promptly), the query or the case list follows as CPU tensors, and the
search is the 1-D sharded path of parallel/mesh.py over a global mesh of
world_size x local shards.  Packs and winner rows come back with
`all_gather` on CPU tensors; process 0 writes the output.  Every exchange
between processes is of host tensors, so Gloo carries it, also between two
processes that share one card (NCCL refuses two ranks on one GPU).

Launch locally with `psa-torch-dist -np N` (utils/launcher.py), or one
`psa-torch --distributed --coordinator HOST:PORT --num-processes N
--process-id R` per process, or under torchrun (`--distributed` alone reads
its environment).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from psa_torch.parallel.mesh import process_layout

# A finite limit on the group's rendezvous and on each collective
# (torch.distributed's own default is 30 minutes): a missing or failed rank
# makes the others fail instead of hang.  PSA_DIST_TIMEOUT overrides it, in
# seconds.
DEFAULT_TIMEOUT_S = 120.0


def _timeout() -> datetime.timedelta:
    try:
        s = float(os.environ.get("PSA_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    except ValueError:
        s = DEFAULT_TIMEOUT_S
    return datetime.timedelta(seconds=s)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               force: bool = False) -> None:
    """Join the process group (the reference's MPI_Init, main.c:20-22).

    With a coordinator HOST:PORT, the process count and this rank, it forms
    a Gloo group through tcp://HOST:PORT (the `mpiexec -np N` analog; the
    launcher passes these).  With no arguments it is a no-op unless
    `force`, when it reads torchrun's environment (env://); one process is
    always a no-op."""
    import torch.distributed as dist

    if num_processes in (None, 1) and coordinator_address is None:
        if force:
            dist.init_process_group("gloo", init_method="env://",
                                    timeout=_timeout())
        return
    if num_processes == 1:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a process group needs the coordinator address, "
                         "the process count and this process's id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=_timeout())


def shutdown() -> None:
    """Leave the process group, if one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    return process_layout()[1] == 0


def local_rank() -> int:
    """This process's index on its machine: torchrun's LOCAL_RANK, else the
    rank (the launcher starts every rank on one machine)."""
    try:
        return int(os.environ["LOCAL_RANK"])
    except (KeyError, ValueError):
        return process_layout()[1]


def rank_device(device: str = "cuda") -> torch.device:
    """The device of this rank's shards: cuda:(local rank % cards), or the
    CPU when asked; without a card "cuda" raises."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to "
                           "run on the host")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def _bcast(t: torch.Tensor) -> torch.Tensor:
    """Broadcast a CPU tensor from process 0 in place (nothing to send for
    an empty one)."""
    import torch.distributed as dist

    if t.numel():
        dist.broadcast(t, src=0)
    return t


def broadcast_query(query=None):
    """Broadcast (weights, codes1, codes2, is_max) from process 0 to all:
    a header (n1, n2, is_max), the four f64 weights and the two code
    arrays.  One process returns `query` unchanged."""
    if process_layout()[0] == 1:
        return query

    from psa_torch.core.alphabet import encode

    if is_primary():
        c1 = torch.from_numpy(encode(query.seq1).astype(np.uint8))
        c2 = torch.from_numpy(encode(query.seq2).astype(np.uint8))
        header = torch.tensor([c1.shape[0], c2.shape[0], int(query.is_max)],
                              dtype=torch.int64)
        w = torch.from_numpy(np.asarray(query.weights, np.float64).copy())
    else:
        header = torch.zeros(3, dtype=torch.int64)
        w = torch.zeros(4, dtype=torch.float64)
    _bcast(header)
    _bcast(w)
    n1, n2, is_max = (int(x) for x in header)
    if not is_primary():
        c1 = torch.zeros(n1, dtype=torch.uint8)
        c2 = torch.zeros(n2, dtype=torch.uint8)
    _bcast(c1)
    _bcast(c2)
    return (w.numpy(), c1.numpy().astype(np.int32),
            c2.numpy().astype(np.int32), bool(is_max))


def _partition(n: int, nproc: int, pid: int) -> tuple[int, int]:
    """Contiguous equal blocks, remainder to the last rank: the reference's
    offset partition rule (cpu_funcs.c:128-133) on the case axis."""
    per = n // nproc
    lo = per * pid
    hi = n if pid == nproc - 1 else lo + per
    return lo, hi


def broadcast_cases(cases=None):
    """Broadcast a whole case list from process 0: a meta header, one
    (n, 3) header array, the (n, 4) weights and the two concatenated RAW
    BYTE arrays (latin-1), so characters outside the alphabet survive
    under --lenient.  The primary returns its own list, so its outputs are
    byte-identical to one process's by construction."""
    if process_layout()[0] == 1:
        return cases

    from psa_torch.utils.io import Query

    if is_primary():
        heads = torch.tensor([[len(q.seq1), len(q.seq2), int(q.is_max)]
                              for q in cases],
                             dtype=torch.int64).reshape(-1, 3)
        w = torch.from_numpy(np.array(
            [np.asarray(q.weights, np.float64) for q in cases],
            np.float64).reshape(-1, 4))
        b1 = torch.frombuffer(bytearray(
            "".join(q.seq1 for q in cases).encode("latin-1")),
            dtype=torch.uint8)
        b2 = torch.frombuffer(bytearray(
            "".join(q.seq2 for q in cases).encode("latin-1")),
            dtype=torch.uint8)
        meta = torch.tensor([len(cases), b1.numel(), b2.numel()],
                            dtype=torch.int64)
    else:
        meta = torch.zeros(3, dtype=torch.int64)
    _bcast(meta)
    n, t1, t2 = (int(x) for x in meta)
    if not is_primary():
        heads = torch.zeros((n, 3), dtype=torch.int64)
        w = torch.zeros((n, 4), dtype=torch.float64)
        b1 = torch.zeros(t1, dtype=torch.uint8)
        b2 = torch.zeros(t2, dtype=torch.uint8)
    for t in (heads, w, b1, b2):
        _bcast(t)
    if is_primary():
        return cases

    heads, w = heads.numpy(), w.numpy()
    s1, s2 = b1.numpy().tobytes(), b2.numpy().tobytes()
    out, o1, o2 = [], 0, 0
    for i in range(n):
        n1, n2, is_max = (int(x) for x in heads[i])
        out.append(Query(weights=w[i],
                         seq1=s1[o1: o1 + n1].decode("latin-1"),
                         seq2=s2[o2: o2 + n2].decode("latin-1"),
                         is_max=bool(is_max)))
        o1 += n1
        o2 += n2
    return out


def _read_on_primary(read_fn, input_path: str, lenient: bool, valid_fn):
    """Primary-only read and validation, with a status broadcast BEFORE any
    payload broadcast, so a bad input file fails every rank promptly.
    Returns the payload on the primary, None elsewhere; raises the
    primary's error on every rank."""
    payload, status = None, 0
    if is_primary():
        try:
            payload = read_fn(input_path)
            if not lenient and not valid_fn(payload):
                status = 3
        except FileNotFoundError:
            status = 1
        except ValueError:
            status = 2
    if process_layout()[0] > 1:
        status = int(_bcast(torch.tensor([status], dtype=torch.int64))[0])
    if status == 1:
        raise FileNotFoundError(input_path)
    if status == 2:
        raise ValueError(f"bad input file `{input_path}`")
    if status == 3:
        from psa_torch.core.alphabet import ALPHABET_ERROR

        raise ValueError(ALPHABET_ERROR)
    return payload


def run_distributed_search(input_path: str, output_path: str,
                           lenient: bool = False, mesh=None) -> int:
    """Full multi-process flow: process 0 reads, the query broadcasts, the
    offsets shard over the global mesh (this process's `mesh`, default
    [rank_device()], times the world size), process 0 writes.  Returns 0,
    or 1 when no mutation exists, like the CLI; raises the primary's read
    or validation error on every rank."""
    from psa_torch.core.alphabet import encode, validate
    from psa_torch.core.result import NoMutationFound
    from psa_torch.core.tables import build_tables
    from psa_torch.parallel.mesh import search_sharded
    from psa_torch.utils.io import read_input, write_output

    if mesh is None:
        mesh = [rank_device()]
    query = _read_on_primary(read_input, input_path, lenient,
                             lambda q: validate(q.seq1) and validate(q.seq2))
    if process_layout()[0] > 1:
        w, c1, c2, is_max = broadcast_query(query)
    else:
        w = np.asarray(query.weights, np.float64)
        c1, c2 = encode(query.seq1), encode(query.seq2)
        is_max = query.is_max
    tables = build_tables(w, is_max)
    # the primary writes from its ORIGINAL Seq2, never from decoded codes:
    # under --lenient every out-of-alphabet character encodes alike
    try:
        res = search_sharded(c1, c2, tables, mesh)
    except NoMutationFound:
        if is_primary():
            write_output(output_path, query.seq2, -1,
                         float("-inf") if is_max else float("inf"))
        return 1
    if is_primary():
        write_output(output_path, res.mutant(query.seq2), res.offset,
                     res.score)
    return 0


def run_distributed_batch(input_path: str, outdir: str,
                          backend: str = "torch", lenient: bool = False,
                          quiet: bool = False, json_out: bool = False,
                          shard_local: bool = False, device=None) -> int:
    """Multi-process batch flow: process 0 reads, the cases broadcast,
    each rank searches its contiguous block with the batch path on its
    device (`device`, default rank_device(); with shard_local its block's
    queries shard over the mesh of its device), the packed winner rows
    [found, offset, char_offset, sub_code, score] come back with an
    all_gather, process 0 writes out_%04d.txt files.  Outputs byte-match
    one process's `--batch`; returns 0, or 1 when any case has no
    mutation."""
    import sys

    from psa_torch.core.alphabet import validate
    from psa_torch.core.result import SearchResult
    from psa_torch.models.batch import search_batch
    from psa_torch.parallel.mesh import _gather_rows
    from psa_torch.utils.io import format_output, read_cases

    if device is None and backend in ("torch", "auto"):
        device = rank_device()
    cases = _read_on_primary(
        read_cases, input_path, lenient,
        lambda cs: all(validate(q.seq1) and validate(q.seq2) for q in cs))
    cases = broadcast_cases(cases)
    nproc, pid = process_layout()
    lo, hi = _partition(len(cases), nproc, pid)
    # two composable axes: the CASE axis splits across processes, and with
    # shard_local each process shards its block's QUERY axis over its mesh
    mesh = [device] if shard_local and device is not None else None
    block = search_batch(cases[lo:hi], backend=backend,
                         strict_alphabet=False, device=device, mesh=mesh)
    rows = torch.zeros((len(cases), 5), dtype=torch.float64)
    for j, res in enumerate(block):
        if res is not None:
            rows[lo + j] = torch.tensor([1.0, res.offset, res.char_offset,
                                         res.sub_code, res.score],
                                        dtype=torch.float64)
    gathered = _gather_rows(rows).reshape(nproc, len(cases), 5)
    for r in range(nproc):
        rlo, rhi = _partition(len(cases), nproc, r)
        rows[rlo:rhi] = gathered[r, rlo:rhi]
    rows = rows.numpy()
    if not is_primary():
        return 1 if (rows[:, 0] == 0).any() else 0

    os.makedirs(outdir, exist_ok=True)
    n_missing = 0
    for i, q in enumerate(cases):
        found, off, coff, sub, score = rows[i]
        res = None
        if found:
            res = SearchResult(offset=int(off), char_offset=int(coff),
                               sub_code=int(sub), score=float(score))
        else:
            n_missing += 1
        with open(os.path.join(outdir, f"out_{i:04d}.txt"), "w") as f:
            if res is None:
                bad = float("-inf") if q.is_max else float("inf")
                f.write(format_output(q.seq2, -1, bad))
            else:
                f.write(format_output(res.mutant(q.seq2), res.offset,
                                      res.score))
        if json_out:
            from psa_torch.utils.cli import _result_json

            print(_result_json(q, res, case=i), flush=True)
    if not quiet:
        print(f"{len(cases)} cases -> {outdir}/ "
              f"({n_missing} without mutation)", file=sys.stderr, flush=True)
    return 1 if n_missing else 0
