"""The kernel lab's v2 sweep: `_sweep_kernel_v2`'s counterpart on the int8
tensor cores.

The function is `ops/sweep.sweep`'s in the TPU kernel's layout: (8,
noff_pad) int32, rows 0-3 the sign-class counts, row 4 the max fused code,
rows 5-7 zero; class 3 is the
nonzero bytes less the rest, so lenient inputs are exact.  The route is the
TPU lab kernel's: the fused code of every pair comes from a one-hot int8
contraction (here `mma.sync.m16n8k32.s8`), the band is sheared to offsets and
decoded 4 pairs to a 32-bit word, and the counts are folded once per chunk
(csrc/sweep_mma.cu, `sweep_mma_kernel`).

The launch splits Seq2 into segments of whole chunks, one block per (tile,
segment), so that the grid fills the card; segments of one tile meet in
atomics on an output the launch zeroes first.  `segment_plan` models that
split for both lab kernels (csrc/sweep_mma.cuh `launch_split`); v2 folds its
byte-lane counters every chunk, so its segments need no lane cap
(`v2_launch_plan`), and `v2_card_plan` is the card's own split.

`sweep_v2` launches that kernel for CUDA tensors and runs `sweep_v2_plain`
for CPU tensors.  Since v2 computes v1's function, the plain version is
`ops/sweep.sweep_rows_plain` at v2's padding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from psa_torch.core.tables import ScoringTables
from psa_torch.ops import sweep as sw
from psa_torch.ops.common import round_up

TILE = sw.MMA_TILE     # offsets per thread block
CHUNK = sw.MMA_CHUNK   # Seq2 positions per band; Seq2 pads to it

# INT32 operations of the decode per 4-pair word, counted from
# csrc/sweep_mma.cu, which takes two words a step: the byte max 2 (the
# even-byte mask, and half of each of the two __vimax3_s16x2), lo 1 (and),
# hi 2 (shift, and), both 1 (and), the three counters' adds 1.5 (one
# three-input add per counter and step), and the valid count 3 (add, and,
# dp4a).  The fold once per chunk (three dp4a, a shift and an add per 16
# words) is left out.
DECODE_OPS_PER_WORD = 10.5
# Blocks the split aims to give each resident block slot (csrc/sweep_mma.cu
# kBlocksPerSlot).
BLOCKS_PER_SLOT = 2

launches_v2 = 0


def plan_shapes_v2(n1: int, n2: int):
    """(noff, noff_pad, l2p, l1k) for a (n1, n2) query: Seq2 pads to whole
    bands, the offsets to whole thread-block tiles, Seq1 to cover every
    padded offset's window.  Not JAX's padding (tile 2048, chunk 256):
    compare on [:noff]."""
    noff = n1 - n2 + 1
    if noff <= 0:
        raise ValueError("seq2 longer than seq1")
    l2p = round_up(max(n2, 1), CHUNK)
    noff_pad = round_up(noff, TILE)
    return noff, noff_pad, l2p, noff_pad + l2p


def segment_plan(noff_pad: int, l2p: int, slots: int, per_slot: int,
                 lane_chunks: int | None = None) -> dict:
    """The split of one lab launch over a card of `slots` resident block
    slots, as csrc/sweep_mma.cuh `segments` takes it.  Seq2's l2p / CHUNK
    chunks are cut into `segs` segments, the least count that gives every
    slot `per_slot` blocks and keeps a segment within `lane_chunks` chunks
    (None: no cap), capped at one chunk per segment; segment s holds the
    chunks [s C // S, (s + 1) C // S).  The grid is one block per (tile,
    segment).  Returns tiles, chunks, segs, blocks, most_chunks (the longest
    segment), atomic (segments meet in atomics) and segments (each one's
    (first chunk, end chunk))."""
    tiles, chunks = noff_pad // TILE, l2p // CHUNK
    fill = -(-per_slot * slots // tiles)
    lanes = 1 if lane_chunks is None else -(-chunks // lane_chunks)
    segs = min(chunks, max(lanes, fill))
    bounds = [s * chunks // segs for s in range(segs + 1)]
    segments = list(zip(bounds[:-1], bounds[1:]))
    return {"tiles": tiles, "chunks": chunks, "segs": segs,
            "blocks": tiles * segs,
            "most_chunks": max(e - b for b, e in segments),
            "atomic": segs > 1, "segments": segments}


def card_plan(entry: str, noff_pad: int, l2p: int) -> dict:
    """The split a lab launch of these shapes takes on the current CUDA
    device, from C entry point `entry` (csrc/sweep_mma.cuh `write_plan`):
    resident blocks per SM, resident block slots, tiles, chunks, segs,
    blocks, most_chunks."""
    lib = sw.build_library()
    plan = (ctypes.c_longlong * 7)()
    err = getattr(lib, entry)(l2p, noff_pad, plan)
    if err != 0:
        raise RuntimeError(f"{entry} failed: " + lib.psa_error_string(err).decode())
    return dict(zip(("blocks_per_sm", "slots", "tiles", "chunks", "segs",
                     "blocks", "most_chunks"), plan))


def v2_launch_plan(noff_pad: int, l2p: int, slots: int) -> dict:
    """`segment_plan` of one v2 launch: BLOCKS_PER_SLOT blocks per slot, no
    lane cap (the counters fold every chunk)."""
    return segment_plan(noff_pad, l2p, slots, BLOCKS_PER_SLOT)


def v2_card_plan(noff_pad: int, l2p: int) -> dict:
    """The split a v2 launch of these shapes takes on the current CUDA
    device (csrc/sweep_mma.cu psa_sweep_v2_plan); `v2_launch_plan` with
    its slots gives the same tiles, chunks, segs, blocks and most_chunks."""
    return card_plan("psa_sweep_v2_plan", noff_pad, l2p)


def check_v2(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor):
    """Validate a lab sweep's operands; returns (noff_pad, l2p)."""
    return sw.check_single(c1, c2, code, TILE, CHUNK)


def sweep_v2(c1: torch.Tensor, c2: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """(8, noff_pad) int32 sweep statistics (see the module docstring).

    c1: (noff_pad + l2p,) uint8 codes; c2: (l2p,) uint8 codes; code: (32, 32)
    int8 fused table; noff_pad a multiple of TILE, l2p of CHUNK.  CUDA
    tensors go through the tensor-core kernel, CPU tensors through
    `sweep_v2_plain`."""
    global launches_v2
    noff_pad, _ = check_v2(c1, c2, code)
    if c1.device.type == "cpu":
        return sweep_v2_plain(c1, c2, code)
    if c1.device.type != "cuda":
        raise ValueError(f"no sweep for device {c1.device}")
    out = sw.launch("psa_sweep_v2_launch", c1, c2, code, (8, noff_pad))
    launches_v2 += 1
    return out


def sweep_v2_plain(c1: torch.Tensor, c2: torch.Tensor,
                   code: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `sweep_v2`: v2 computes `sweep`'s
    function, so this is `ops/sweep.sweep_rows_plain` at v2's padding."""
    return sw.sweep_rows_plain(c1, c2, code, tile=TILE, align=CHUNK)


def offset_stats_v2(codes1: np.ndarray, codes2: np.ndarray,
                    tables: ScoringTables, device):
    """Per-offset (counts (noff, 4) int32, maxrank (noff,) int32) on the
    host, computed by `sweep_v2` on `device`."""
    return sw.stats_via(lambda *a: sw.stats5_from_sweep(sweep_v2(*a)),
                        plan_shapes_v2, codes1, codes2, tables, device)
