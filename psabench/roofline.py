"""The work of a query, counted from its shapes, and the least time the card
could take for it (peaks.py).

A query of Seq1 length n1 and Seq2 length n2 has (n1 - n2 + 1) offsets of
n2 positions each: (n1 - n2 + 1) * n2 real pairs, whatever kernels do the
work and however they pad.  Each pair is one multiply-accumulate, two
operations, counted at the card's densest rate (int8 on the tensor cores),
so no route can beat the floor.  Bytes: the query's Seq1 and Seq2 codes
read once (one byte a character) and its result written once (offset,
position, substitute and score: four 8-byte words).  A route that needed
fewer operations than pairs (a transform-based correlation) would have to be
counted again.
"""

from __future__ import annotations

from psabench import peaks

OPS_PER_PAIR = 2          # one multiply-accumulate
RESULT_BYTES = 4 * 8      # offset, char offset, substitute, score


def pairs(n1: int, n2: int) -> int:
    """Real (offset, position) pairs of one query."""
    return max(n1 - n2 + 1, 0) * n2


def operations(n1: int, n2: int) -> int:
    return OPS_PER_PAIR * pairs(n1, n2)


def bytes_moved(n1: int, n2: int) -> int:
    """Bytes a query must move at the least: its codes in, its result out."""
    return n1 + n2 + RESULT_BYTES


def ops_floor_s(n1: int, n2: int) -> float:
    return operations(n1, n2) / peaks.INT8_OPS_PER_S


def bytes_floor_s(n1: int, n2: int) -> float:
    return bytes_moved(n1, n2) / peaks.HBM_BYTES_PER_S


def floor_s(n1: int, n2: int) -> float:
    """The least time of one query: the larger of the two floors."""
    return max(ops_floor_s(n1, n2), bytes_floor_s(n1, n2))


def bound_by(n1: int, n2: int) -> str:
    """Which floor bounds the query: "operations" or "bytes"."""
    return ("operations" if ops_floor_s(n1, n2) >= bytes_floor_s(n1, n2)
            else "bytes")
