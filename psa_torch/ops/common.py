"""Shared helpers for the device path: rounding and the f32 keyed totals."""

from __future__ import annotations

import torch


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def keyed_f32_totals_ops(counts: torch.Tensor, maxrank: torch.Tensor,
                         w32: torch.Tensor, diff32: torch.Tensor,
                         is_max: bool, noff):
    """f32 ranking totals in the rows layout.

    counts: (..., 4, N) int class counts (offset axis minor); maxrank:
    (..., N) int;
    w32: (4,) f32 signed class weights; diff32: (num_ranks + 1,) f32
    rank -> diff with a zero appended (read only when there are no ranks,
    since maxrank < num_ranks); noff: the real offset count, an int or a
    per-row (...,) tensor.  Returns (keyed, total): `total` is the f32
    post-substitution score per offset, summed in the order
    w0*c0 + w1*c1 + w2*c2 + w3*c3 + diff, and `keyed` is sign-folded
    (argmax = mode-best) with offsets >= noff or without a substitution at
    -inf.  The ranking is approximate by design: callers pair it with the
    exact integer stats and a host re-score (models/batch.py).
    """
    c = counts.to(torch.float32)
    total = (w32[0] * c[..., 0, :] + w32[1] * c[..., 1, :]
             + w32[2] * c[..., 2, :] + w32[3] * c[..., 3, :])
    total = total + diff32[maxrank.clamp(min=0).long()]
    offs = torch.arange(maxrank.shape[-1], device=maxrank.device)
    if isinstance(noff, torch.Tensor):
        noff = noff[..., None]
    valid = (maxrank >= 0) & (offs < noff)
    sign = 1.0 if is_max else -1.0
    keyed = torch.where(valid, sign * total,
                        torch.full_like(total, float("-inf")))
    return keyed, total
