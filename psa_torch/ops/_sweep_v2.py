"""The kernel lab's v2 sweep: `_sweep_kernel_v2`'s counterpart on the int8
tensor cores.

The function is `ops/sweep.sweep`'s in the TPU kernel's layout: (8,
noff_pad) int32, rows 0-3 the sign-class counts, row 4 the max fused code,
rows 5-7 zero; class 3 is the
nonzero bytes less the rest, so lenient inputs are exact.  The route is the
TPU lab kernel's: the fused code of every pair comes from a one-hot int8
contraction (here `mma.sync.m16n8k32.s8`), the band is sheared to offsets and
decoded 4 pairs to a 32-bit word, and the counts are folded once per chunk
(csrc/sweep_mma.cu, `sweep_mma_kernel<false>`).

`sweep_v2` launches that kernel for CUDA tensors and runs `sweep_v2_plain`
for CPU tensors.  Since v2 computes v1's function, the plain version is
`ops/sweep.sweep_rows_plain` at v2's padding.
"""

from __future__ import annotations

import numpy as np
import torch

from psa_torch.core.tables import ScoringTables
from psa_torch.ops import sweep as sw
from psa_torch.ops.common import round_up

TILE = sw.MMA_TILE     # offsets per thread block
CHUNK = sw.MMA_CHUNK   # Seq2 positions per band; Seq2 pads to it

# INT32 operations of the decode per 4-pair word, counted from
# csrc/sweep_mma.cu: the byte max, lo (and), hi (shift, and), both (and),
# three adds, and the valid count (add, and, shift, add); the fold's four dp4a
# per 16 words are left out.  With the max counted as one operation this is a
# floor: __vmaxu4 is emulated on Hopper.
DECODE_OPS_PER_WORD = 12

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
