"""The kernel lab's v3 sweep: `_sweep_kernel_v3`'s counterpart on the int8
tensor cores, for clean inputs.

The kernel (csrc/sweep_mma_v3.cu, `sweep_v3_kernel`) is v2's band with
deferred counting: byte-wise class-mask counters run over a whole segment
of Seq2 and are folded once, and it makes no valid count.  So its (8,
noff_pad) output has rows 0-2 and 4 of `sweep`'s and row 3 zero;
`offset_stats_v3` rebuilds class 3 as n2 - the rest, which is exact only
when every pair of the real window is valid (no OTHER_CODE), as in the JAX
package's `offset_stats_v3`.

The launch splits Seq2 into segments of whole chunks, one block per (tile,
segment), so that the grid fills the card; `v3_launch_plan` is the model
of that split and `v3_card_plan` the card's.  Segments of one tile meet in
atomics on an output the launch zeroes first.

It takes the inputs JAX's v3 takes: `_sweep_pallas_v3` refuses more than
127 chunks of 256, i.e. n2 > 32,512, and so does this module (ValueError).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from psa_torch.core.tables import ScoringTables
from psa_torch.ops import sweep as sw
from psa_torch.ops._sweep_v2 import CHUNK, TILE, check_v2, plan_shapes_v2

MAX_N2 = 127 * 256

# INT32 operations of the decode per 4-pair word, counted from
# csrc/sweep_mma_v3.cu, which takes two words a step: the byte max 2 (the
# even-byte mask, and half of each of the two __vimax3_s16x2), lo 1 (and),
# hi 2 (shift, and), both 1 (and), and the three counters' adds 1.5 (one
# three-input add per counter and step).
DECODE_OPS_PER_WORD = 7.5
# Chunks a segment may hold: a byte-lane counter gains at most CHUNK / 4 a
# chunk and must stay below 256 (csrc/sweep_mma_v3.cu kLaneChunks).
LANE_CHUNKS = 255 // (CHUNK // 4)
# Blocks the split aims to give each resident block slot (kBlocksPerSlot).
BLOCKS_PER_SLOT = 2

launches_v3 = 0


def plan_shapes_v3(n1: int, n2: int):
    """`plan_shapes_v2`, refusing n2 > MAX_N2 as the JAX kernel does."""
    if n2 > MAX_N2:
        raise ValueError(f"v3 takes n2 <= {MAX_N2}, got {n2}")
    return plan_shapes_v2(n1, n2)


def check_v3(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor):
    """`check_v2`, refusing a padded Seq2 longer than MAX_N2."""
    shapes = check_v2(c1, c2, code)
    if shapes[1] > MAX_N2:
        raise ValueError(f"v3 takes l2p <= {MAX_N2}, got {shapes[1]}")
    return shapes


def v3_launch_plan(noff_pad: int, l2p: int, slots: int) -> dict:
    """The split of one v3 launch over a card of `slots` resident block
    slots, as csrc/sweep_mma_v3.cu takes it.  Seq2's l2p / CHUNK chunks are
    cut into `segs` segments, the least count that gives every slot
    BLOCKS_PER_SLOT blocks and keeps a segment within LANE_CHUNKS chunks,
    capped at one chunk per segment; segment s holds the chunks [s C // S,
    (s + 1) C // S).  The grid is one block per (tile, segment).  Returns
    tiles, chunks, segs, blocks, most_chunks (the longest segment), atomic
    (segments meet in atomics) and segments (each one's (first chunk, end
    chunk))."""
    tiles, chunks = noff_pad // TILE, l2p // CHUNK
    fill = -(-BLOCKS_PER_SLOT * slots // tiles)
    segs = min(chunks, max(-(-chunks // LANE_CHUNKS), fill))
    bounds = [s * chunks // segs for s in range(segs + 1)]
    segments = list(zip(bounds[:-1], bounds[1:]))
    return {"tiles": tiles, "chunks": chunks, "segs": segs,
            "blocks": tiles * segs,
            "most_chunks": max(e - b for b, e in segments),
            "atomic": segs > 1, "segments": segments}


def v3_card_plan(noff_pad: int, l2p: int) -> dict:
    """The split a v3 launch of these shapes takes on the current CUDA
    device (csrc/sweep_mma_v3.cu psa_sweep_v3_plan): resident blocks per
    SM, resident block slots, tiles, chunks, segs, blocks, most_chunks.
    `v3_launch_plan` with its slots gives the same tiles, chunks, segs,
    blocks and most_chunks."""
    lib = sw.build_library()
    plan = (ctypes.c_longlong * 7)()
    err = lib.psa_sweep_v3_plan(l2p, noff_pad, plan)
    if err != 0:
        raise RuntimeError("psa_sweep_v3_plan failed: "
                           + lib.psa_error_string(err).decode())
    return dict(zip(("blocks_per_sm", "slots", "tiles", "chunks", "segs",
                     "blocks", "most_chunks"), plan))


def sweep_v3(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """(8, noff_pad) int32: `sweep_v2`'s rows with row 3 zero.  Operands as
    for `sweep_v2`, l2p <= MAX_N2.  CUDA tensors go through the
    tensor-core kernel, CPU tensors through `sweep_v3_plain`."""
    global launches_v3
    noff_pad, _ = check_v3(c1, c2, code)
    if c1.device.type == "cpu":
        return sweep_v3_plain(c1, c2, code)
    if c1.device.type != "cuda":
        raise ValueError(f"no sweep for device {c1.device}")
    out = sw.launch("psa_sweep_v3_launch", c1, c2, code, (8, noff_pad))
    launches_v3 += 1
    return out


def sweep_v3_plain(c1: torch.Tensor, c2: torch.Tensor,
                   code: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `sweep_v3`: `ops/sweep.sweep_rows_plain`
    at v3's padding with row 3 zeroed."""
    check_v3(c1, c2, code)
    out = sw.sweep_rows_plain(c1, c2, code, tile=TILE, align=CHUNK)
    out[3] = 0
    return out


def offset_stats_v3(codes1: np.ndarray, codes2: np.ndarray,
                    tables: ScoringTables, device):
    """Clean-input per-offset (counts (noff, 4) int32, maxrank (noff,)
    int32) on the host, computed by `sweep_v3` on `device`; class 3 is
    n2 - c0 - c1 - c2 with the real n2."""
    n2 = int(np.asarray(codes2).shape[0])
    counts, maxrank = sw.stats_via(lambda *a: sw.stats5_from_sweep(sweep_v3(*a)),
                                   plan_shapes_v3, codes1, codes2, tables,
                                   device)
    counts[:, 3] = n2 - counts[:, 0] - counts[:, 1] - counts[:, 2]
    return counts, maxrank
