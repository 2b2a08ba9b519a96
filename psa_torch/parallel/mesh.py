"""Offset-axis sharding over a list of devices: the port of the JAX
package's parallel/mesh.py.

A mesh here is a plain list of `torch.device`s, one per shard; a device may
appear more than once (`["cuda:0"] * 4`, `["cpu"] * 8`), and then its shards
run one after another on its current stream.  That is the port's
counterpart of the virtual devices the JAX tests shard over, nothing more.

* 1-D (`search_sharded`): Seq1 and Seq2 are uploaded once per device; the
  offset axis splits into equal blocks, and each shard runs `ops/sweep.sweep`
  on its view `c1[o0 : o0 + per_shard + l2p]` of that one upload, then the
  checkable-exact top-k epilogue with global offsets.  The host merges the
  (n_shards, 6k+2) packs (`_select_from_shard_topk`); when some shard holds
  more than k offsets inside the f32 band of the global best, it falls back
  to the full stats and `select_best`.
* 2-D (`search_sharded_2d`): an (n_op, n_ch) grid; shard (i, j) sweeps
  offset block i over Seq2 chunk j, the "ch" reduction runs on the devices
  (counts summed, rank maxed, each shard keeping its owned block), then the
  epilogue with the epsilon of the full l2p.
* The per-shard kernel (`kernel=`): "auto" runs the CUDA sweep
  (ops/sweep.sweep, its plain version on CPU shards); "xla" runs the gather
  engine (ops/engine_xla.stats5_xla), the counterpart of the JAX package's
  `_local_stats_jnp`: the differential reference of the sharded path.  Both
  give the same stats5 layout, so the epilogue, the merge and the fallback
  do not depend on it.
* Multi-process (parallel/multihost.py): when a torch.distributed group is
  up, `mesh` lists this process's shards and the global mesh is world_size
  x len(mesh) shards, rank r owning [r L, (r + 1) L); the packs (and the
  fallback's full stats) are gathered over the group as CPU tensors.

Winners are exact: the device ranks offsets in f32 but hands the host
exact integer statistics, as the single-device path does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from psa_torch.core.alphabet import pad_codes
from psa_torch.core.result import NoMutationFound, SearchResult
from psa_torch.core.tables import (ScoringTables, device_tables_cached,
                                   f32_band_epsilon)
from psa_torch.ops.common import round_up
from psa_torch.ops.epilogue import TOPK, epilogue_pack, unpack_epilogue_outputs
from psa_torch.ops.select import band_candidates, pick_rows, select_best
from psa_torch.ops.sweep import L2_ALIGN, TILE_O, sweep, upload_codes

# Full-stats fallbacks taken by search_sharded and search_sharded_2d: a
# plain integer a caller can zero and read.
fallbacks = 0


def make_mesh(devices=None) -> list:
    """1-D mesh: a list of torch.device, one per shard.  None means every
    CUDA device, and raises without one (like models/search.resolve_device);
    entries may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass 'cpu' "
                               "devices (--device cpu) to run on the host")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def make_mesh_2d(devices=None, n_op: int = 1, n_ch: int = 1) -> list:
    """2-D (n_op, n_ch) mesh: n_op rows of n_ch devices, shard (i, j)
    sweeping offset block i over Seq2 chunk j."""
    flat = make_mesh(devices)[: n_op * n_ch]
    if n_op < 1 or n_ch < 1 or len(flat) != n_op * n_ch:
        raise ValueError(f"a ({n_op}, {n_ch}) mesh needs {n_op * n_ch} "
                         f"devices, got {len(flat)}")
    return [flat[i * n_ch:(i + 1) * n_ch] for i in range(n_op)]


def process_layout() -> tuple[int, int]:
    """(world size, rank) of the torch.distributed group, (1, 0) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every process's rows in rank order (CPU tensors over the group; the
    identity in one process)."""
    world, _ = process_layout()
    if world == 1:
        return local
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def _offsets(codes1, codes2) -> int:
    noff = np.asarray(codes1).shape[0] - np.asarray(codes2).shape[0] + 1
    if noff <= 0:
        raise ValueError("seq2 longer than seq1")
    return noff


def pad_for_mesh(codes1: np.ndarray, codes2: np.ndarray, n_shards: int):
    """Pad so the offset axis splits into n_shards blocks of whole warp
    tiles (TILE_O) and Seq2 to L2_ALIGN -> (c1p, c2p, noff)."""
    noff = _offsets(codes1, codes2)
    l2p = round_up(max(codes2.shape[0], L2_ALIGN), L2_ALIGN)
    noff_pad = round_up(noff, n_shards * TILE_O)
    return pad_codes(codes1, noff_pad + l2p), pad_codes(codes2, l2p), noff


def pad_for_mesh_2d(codes1: np.ndarray, codes2: np.ndarray, n_op: int,
                    n_ch: int):
    """Pad so the offset axis splits into n_op x n_ch blocks of whole warp
    tiles (each shard's owned block after the "ch" reduction) and Seq2 into
    n_ch chunks of whole L2_ALIGN units, so every chunk's Seq1 window
    starts on a 16-byte boundary -> (c1p, c2p, noff)."""
    noff = _offsets(codes1, codes2)
    l2p = round_up(max(codes2.shape[0], L2_ALIGN * n_ch), L2_ALIGN * n_ch)
    noff_pad = round_up(noff, n_op * n_ch * TILE_O)
    return pad_codes(codes1, noff_pad + l2p), pad_codes(codes2, l2p), noff


def _place(devices, tables: ScoringTables, c1p, c2p) -> dict:
    """One upload of both padded sequences (one buffer, pinned on the card:
    ops/sweep.upload_codes) and the tables per distinct device: device ->
    (c1d, c2d, DeviceTables)."""
    placed = {}
    for dev in devices:
        if dev not in placed:
            placed[dev] = (*upload_codes(dev, (c1p, c1p.shape[0]),
                                         (c2p, c2p.shape[0])),
                           device_tables_cached(tables, dev))
    return placed


KERNELS = ("auto", "xla")


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown shard kernel {kernel!r}; choose from "
                         f"{KERNELS}")


def _shard_stats(kernel: str, c1: torch.Tensor, c2: torch.Tensor,
                 code: torch.Tensor) -> torch.Tensor:
    """(5, width) stats5 of one shard's Seq1 view c1 (width + len(c2)
    codes) under c2: the sweep, or the gather engine for "xla"."""
    if kernel == "xla":
        from psa_torch.ops.engine_xla import stats5_xla

        return stats5_xla(c1, c2, code, c1.shape[0] - c2.shape[0])
    return sweep(c1, c2, code)


def _local_shards(mesh: list):
    """(global shard index, device) of this process's shards."""
    _, rank = process_layout()
    return [(rank * len(mesh) + s, dev) for s, dev in enumerate(mesh)]


def sharded_offset_stats(codes1p: np.ndarray, codes2p: np.ndarray,
                         tables: ScoringTables, mesh: list,
                         kernel: str = "auto") -> torch.Tensor:
    """Global (noff_pad, 5) int32 stats on the host, rows 0-3 the class
    counts and row 4 the maxrank, the offset axis block-sharded over the
    mesh (over every process's mesh under a process group).  codes1p and
    codes2p come padded from `pad_for_mesh` for the global shard count;
    `kernel` is the per-shard sweep ("auto" or "xla")."""
    _check_kernel(kernel)
    mesh = make_mesh(mesh)
    world, _ = process_layout()
    n = world * len(mesh)
    l2p = codes2p.shape[0]
    noff_pad = codes1p.shape[0] - l2p
    if noff_pad % (n * TILE_O):
        raise ValueError(f"pad the offsets to {n} x {TILE_O} (pad_for_mesh)")
    per = noff_pad // n
    placed = _place(mesh, tables, codes1p, codes2p)
    parts = []
    for g, dev in _local_shards(mesh):
        c1d, c2d, dtabs = placed[dev]
        o0 = g * per
        parts.append(_shard_stats(kernel, c1d[o0: o0 + per + l2p], c2d,
                                  dtabs.code))
    local = torch.cat([p.cpu() for p in parts], dim=1).T.contiguous()
    return _gather_rows(local)


def _shard_pack(stats5: torch.Tensor, dtabs, noff: int, g0: int,
                width: int, l2p: int) -> torch.Tensor:
    """One shard's (1, 6k+2) pack: the top-k epilogue on its block of
    `width` offsets starting at global offset g0, with global offsets
    (ops/epilogue.epilogue_pack: the kernel on the card)."""
    noff_local = min(max(noff - g0, 0), width)
    return epilogue_pack(stats5[None], dtabs, noff_local, l2p, TOPK, g0)


def _select_from_shard_topk(buf: np.ndarray, noff: int, l2p: int,
                            tables: ScoringTables, codes1,
                            codes2) -> SearchResult | None:
    """Exact host selection from per-shard top-k candidate rows.

    Returns a SearchResult, or None when the f32 ranking was insufficient
    for some contributing shard (near > k inside the global band): the
    caller falls back to the full stats.  Raises NoMutationFound when no
    shard found any legal substitution.  Shards that hold only padding have
    best = -inf and drop out of both tests."""
    topi, stats_k, near, best = unpack_epilogue_outputs(buf, TOPK)
    if np.all(np.isneginf(best)):
        raise NoMutationFound("no offset admits a legal substitution")
    bg = best.max()
    eps32 = f32_band_epsilon(tables, l2p)
    # every offset within the f32 band of the GLOBAL best must be in its
    # shard's top k; a shard whose own band held more than k can hide one
    # only if its local best reaches the global band
    if np.any((near > TOPK) & (best >= bg - eps32)):
        return None
    # one row of every shard's candidates; shards own disjoint blocks, so
    # the row's ascending offsets give the lowest-offset tie-break
    c1 = np.asarray(codes1, np.int32)
    c2 = np.asarray(codes2, np.int32)
    n2s = np.array([c2.shape[0]], np.int32)
    rows, cand = band_candidates(topi.reshape(1, -1),
                                 np.swapaxes(stats_k, 1, 2).reshape(1, -1, 5),
                                 [noff], n2s, tables)
    res = pick_rows(c1[None], c2[None], n2s, tables, rows, cand, 1)[0]
    if res is None:
        raise NoMutationFound("no offset admits a legal substitution")
    return res


def _full_stats_select(codes1, codes2, tables: ScoringTables,
                       mesh: list, kernel: str) -> SearchResult:
    """The fallback: every offset's stats over a flat 1-D mesh, then the
    unrestricted exact selection."""
    global fallbacks
    fallbacks += 1
    world, _ = process_layout()
    c1p, c2p, noff = pad_for_mesh(codes1, codes2, world * len(mesh))
    stats = sharded_offset_stats(c1p, c2p, tables, mesh, kernel).numpy()
    return select_best(stats[:, :4], stats[:, 4], tables,
                       np.asarray(codes1, np.int32),
                       np.asarray(codes2, np.int32), noff=noff)


def search_sharded(codes1: np.ndarray, codes2: np.ndarray,
                   tables: ScoringTables, mesh: list | None = None,
                   kernel: str = "auto") -> SearchResult:
    """End-to-end 1-D sharded search -> SearchResult (exact host
    selection).  Each shard sweeps its block with `kernel` ("auto" = the
    CUDA sweep, "xla" = the gather engine) and reduces it to k exact
    candidates on its device, so the host fetches (6k+2) ints per shard;
    when the f32 ranking cannot certify the winner the full stats are swept
    again and selected without restriction."""
    _check_kernel(kernel)
    mesh = make_mesh(mesh)
    world, _ = process_layout()
    n = world * len(mesh)
    c1p, c2p, noff = pad_for_mesh(codes1, codes2, n)
    l2p = c2p.shape[0]
    per = (c1p.shape[0] - l2p) // n
    placed = _place(mesh, tables, c1p, c2p)
    packs = []
    for g, dev in _local_shards(mesh):
        c1d, c2d, dtabs = placed[dev]
        o0 = g * per
        stats5 = _shard_stats(kernel, c1d[o0: o0 + per + l2p], c2d,
                              dtabs.code)
        packs.append(_shard_pack(stats5, dtabs, noff, o0, per, l2p))
    # every shard's work is enqueued before the first fetch waits
    buf = _gather_rows(torch.cat([p.cpu() for p in packs]))
    res = _select_from_shard_topk(buf.numpy(), noff, l2p, tables, codes1,
                                  codes2)
    if res is not None:
        return res
    return _full_stats_select(codes1, codes2, tables, mesh, kernel)


def search_sharded_2d(codes1: np.ndarray, codes2: np.ndarray,
                      tables: ScoringTables, mesh: list,
                      kernel: str = "auto") -> SearchResult:
    """End-to-end 2-D (offset x char) sharded search -> SearchResult.

    Shard (i, j) sweeps offset block i over Seq2 chunk j (a chunk is just a
    shorter Seq2 to the kernel).  Then, on the devices: the class counts of
    row i's shards are summed and their ranks maxed (exact integers; a peer
    copy where two devices differ, none where they are the same), each
    shard keeping its owned block of per_op / n_ch offsets, and the
    epilogue ranks it with the f32 band of the FULL l2p (the reduced stats
    are full-length sums; the chunk's band would be too narrow to certify
    the winner).  The host merge is the 1-D path's; the rare uncertifiable
    case re-runs through the full stats on a flat mesh of the same
    devices.  `kernel` as in `search_sharded`.  One process only."""
    _check_kernel(kernel)
    if process_layout()[0] > 1:
        raise ValueError("the 2-D mesh runs in one process; use "
                         "search_sharded under a process group")
    n_op, n_ch = len(mesh), len(mesh[0])
    c1p, c2p, noff = pad_for_mesh_2d(codes1, codes2, n_op, n_ch)
    l2p = c2p.shape[0]
    per_op = (c1p.shape[0] - l2p) // n_op
    blk = per_op // n_ch
    lc = l2p // n_ch
    flat = [d for row in mesh for d in row]
    placed = _place(flat, tables, c1p, c2p)
    stats = []
    for i, row in enumerate(mesh):
        stats.append([])
        for j, dev in enumerate(row):
            c1d, c2d, dtabs = placed[dev]
            w0 = i * per_op + j * lc
            stats[i].append(_shard_stats(kernel, c1d[w0: w0 + per_op + lc],
                                         c2d[j * lc: (j + 1) * lc],
                                         dtabs.code))
    packs = []
    for i, row in enumerate(mesh):
        for j, dev in enumerate(row):
            part = torch.stack([
                s[:, j * blk: (j + 1) * blk].to(dev, non_blocking=True)
                for s in stats[i]])                       # (n_ch, 5, blk)
            owned = torch.cat([part[:, :4].sum(0, dtype=torch.int32),
                               part[:, 4:5].amax(0)])     # (5, blk)
            packs.append(_shard_pack(owned, placed[dev][2], noff,
                                     i * per_op + j * blk, blk, l2p))
    buf = torch.cat([p.cpu() for p in packs]).numpy()
    res = _select_from_shard_topk(buf, noff, l2p, tables, codes1, codes2)
    if res is not None:
        return res
    return _full_stats_select(codes1, codes2, tables, flat, kernel)


# choose_mesh_shape's conversion of link bytes into sweep work: the pairs
# the card's sweep retires in the time one byte crosses NVLink.  The rate is
# measured, the link is not: `sweep` back to back at 131072 x 8192 runs
# 6.0e12-6.2e12 pair-evals/s (chip_smoke.py sweep_time, H100 80GB HBM3,
# 700 W; PERF.md §6), and NVLink 4 moves 450 GB/s per direction on an H100
# SXM (the data sheet's 900 GB/s, both directions).  6.1e12 / 450e9 = 13.6.
# A one-card machine cannot measure the link.
_PAIRS_PER_NVLINK_BYTE = 13.6
# bytes the "ch" reduction brings to a shard per owned offset from each
# other chunk: one stats5 column, 5 int32
_CH_BYTES_PER_OFFSET = 20
# shortest Seq2 chunk a char split may leave: 8 of the kernel's 32-position
# units, as the JAX package keeps two of its 128-char chunks
_MIN_CHUNK = 256


def choose_mesh_shape(ndev: int, noff: int, n2: int) -> tuple[int, int]:
    """(n_op, n_ch) minimizing per-shard sweep work plus the modeled "ch"
    reduction.

    The card's sweep does each padded (offset, position) pair once, with
    no window-overlap work (csrc/sweep.cu), so a shard's work is its padded
    pairs, per_op x lc, the same at every shape up to Seq2's padding; the
    "ch" reduction adds _CH_BYTES_PER_OFFSET x per_op x (n_ch - 1) / n_ch
    bytes at _PAIRS_PER_NVLINK_BYTE.  So the offset split wins wherever the
    padding does not favour a char split, unlike the JAX package's TPU
    model, where the window overlap ((per_op + lc) x lc) made char sharding
    pay when noff / ndev is comparable to l2p."""
    best, best_cost = (ndev, 1), None
    noff_pad = round_up(noff, ndev * TILE_O)
    n_ch = 1
    while n_ch <= ndev:
        n_op = ndev // n_ch
        if n_op * n_ch == ndev:
            lc = round_up(max(n2, L2_ALIGN * n_ch), L2_ALIGN * n_ch) // n_ch
            if n_ch == 1 or lc >= _MIN_CHUNK:
                per_op = noff_pad / n_op
                cost = per_op * lc + _PAIRS_PER_NVLINK_BYTE * (
                    _CH_BYTES_PER_OFFSET * per_op * (n_ch - 1) / n_ch)
                if best_cost is None or cost < best_cost:
                    best, best_cost = (n_op, n_ch), cost
        n_ch *= 2
    return best


def mesh_shape(ndev: int, noff: int, n2: int) -> tuple[int, int]:
    """The (n_op, n_ch) `search_sharded_auto` takes: PSA_MESH_SHAPE =
    "n_op,n_ch" when set (it must cover ndev), else `choose_mesh_shape`."""
    spec = os.environ.get("PSA_MESH_SHAPE")
    if not spec:
        return choose_mesh_shape(ndev, noff, n2)
    n_op, n_ch = (int(x) for x in spec.split(","))
    if n_op * n_ch != ndev:
        raise ValueError(f"PSA_MESH_SHAPE={spec} does not cover {ndev} "
                         "devices")
    return n_op, n_ch


def search_sharded_auto(codes1: np.ndarray, codes2: np.ndarray,
                        tables: ScoringTables, devices=None,
                        kernel: str = "auto") -> SearchResult:
    """Sharded search with the mesh shape chosen per workload
    (`mesh_shape`): n_ch == 1 through the offset-sharded path, n_ch > 1
    through the 2-D path; `kernel` as in `search_sharded`."""
    mesh = make_mesh(devices)
    n_op, n_ch = mesh_shape(len(mesh), _offsets(codes1, codes2),
                            np.asarray(codes2).shape[0])
    if n_ch == 1:
        return search_sharded(codes1, codes2, tables, mesh, kernel)
    return search_sharded_2d(codes1, codes2, tables,
                             make_mesh_2d(mesh, n_op, n_ch), kernel)
