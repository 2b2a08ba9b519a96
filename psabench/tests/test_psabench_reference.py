"""The plain reference against a brute force of the upstream's loops, and
against the port's own host oracle as a second witness."""

import numpy as np
import pytest
import torch

from psabench import reference as R
from psabench.generator import random_sequences

CONS = ("NDEQ", "NEQK", "STA", "MILV", "QHRK", "NHQK", "FYW", "HY", "MILF")
SEMI = ("SAG", "ATV", "CSA", "SGND", "STPA", "STNK", "NEQHRK", "NDEQHK",
        "SNDEQK", "HFY", "FVLIM")
ABC = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def sign(a, b):
    """cuda_funcs.cu:424-439 on characters."""
    if a == "-" and b == "-":
        return "*"
    if "-" in (a, b):
        return "_"
    if a not in ABC or b not in ABC:
        return "\0"
    if a == b:
        return "*"
    if any(a in g and b in g for g in CONS):
        return ":"
    if any(a in g and b in g for g in SEMI):
        return "."
    return "_"


def weight(s, w):
    return {"*": w[0], ":": -w[1], ".": -w[2], "_": -w[3]}.get(s, 0)


def first_with(by, want, rest):
    for ch in ABC:
        if sign(by, ch) == want and sign(rest, ch) != ":":
            return ch
    return None


def optimal(is_max, d1, s1, d2, s2):
    if (d1 >= d2) if is_max else (d1 <= d2):
        if s1 is not None:
            return s1
    return s2 if s2 is not None else s1


def get_substitute(c1, c2, w, is_max):
    """cuda_funcs.cu:310-393 for one pair, letter by letter."""
    s = sign(c1, c2)
    if s == "\0":
        return None
    if is_max:
        if s in "._":
            return c1
        if s == "*":
            return optimal(True, -w[0] - w[2], first_with(c1, ".", c2),
                           -w[0] - w[3], first_with(c1, "_", c2))
        return optimal(True, w[1] - w[2], first_with(c1, ".", c2),
                       w[1] - w[3], first_with(c1, "_", c2))
    col, dot, spc = (first_with(c1, x, c2) for x in ":._")
    d = {"*": (-w[0] - w[2], dot, -w[0] - w[3], spc),
         ":": (w[1] - w[2], dot, w[1] - w[3], spc),
         ".": (w[2] - w[1], col, w[2] - w[3], spc),
         "_": (w[3] - w[1], col, w[3] - w[2], dot)}[s]
    sub = optimal(False, *d)
    if s in "._" and sub is None:
        return c1
    return sub


def brute(seq1, seq2, w, is_max):
    """The upstream's scan: every offset, left to right, strict improvement
    of the substitution's delta, then the best total at the lowest offset."""
    best = None
    for o in range(len(seq1) - len(seq2) + 1):
        total, bd, bi, bs = 0, None, -1, None
        for i, c2 in enumerate(seq2):
            c1 = seq1[o + i]
            total += weight(sign(c1, c2), w)
            sub = get_substitute(c1, c2, w, is_max)
            if sub is None:
                continue
            d = weight(sign(c1, sub), w) - weight(sign(c1, c2), w)
            if bd is None or (d > bd if is_max else d < bd):
                bd, bi, bs = d, i, sub
        if bi < 0:
            continue
        t = total + bd
        if best is None or (t > best[3] if is_max else t < best[3]):
            best = (o, bi, ord(bs) - 65 if bs != "-" else 26, float(t))
    return best


CASES = [((1, 3, 4, 2), False), ((1, 3, 4, 2), True), ((5, 1, 1, 7), False),
         ((2, -1, 3, 0), True), ((0, 0, 0, 0), False), ((-3, 2, 8, 1), False)]


@pytest.mark.parametrize("w,is_max", CASES)
@pytest.mark.parametrize("seed", range(4))
def test_reference_matches_brute_force(w, is_max, seed):
    rng = np.random.default_rng(seed)
    n1 = int(rng.integers(2, 60))
    n2 = int(rng.integers(1, n1 + 1))
    s1, s2 = random_sequences(n1, n2, seed, hyphen_p=0.15 * (seed % 2))
    if seed == 3:                      # out-of-alphabet characters as well
        s1 = s1[:-1] + "?"
    tables = R.Tables(w, is_max)
    got = R.winner(s1, s2, tables, "cpu", block_elems=7 * n2)
    assert got == brute(s1, s2, w, is_max)


@pytest.mark.parametrize("is_max", [False, True])
def test_reference_ties_go_to_lowest_offset_and_first_position(is_max):
    s1, s2 = "A" * 50, "A" * 7
    tables = R.Tables((1, 3, 4, 2), is_max)
    got = R.winner(s1, s2, tables, "cpu")
    assert got == brute(s1, s2, (1, 3, 4, 2), is_max)
    assert got[:2] == (0, 0)


def test_reference_answers_none_without_a_legal_substitution():
    tables = R.Tables((1, 3, 4, 2), False)
    assert R.winner("??????", "???", tables, "cpu") is None
    assert brute("??????", "???", (1, 3, 4, 2), False) is None


def test_reference_refuses_weights_it_cannot_sum_exactly():
    with pytest.raises(ValueError):
        R.Tables((1.5, 3, 4, 2), False)


@pytest.mark.parametrize("block", [1, 13, 1 << 27])
def test_reference_blocks_do_not_change_the_answer(block):
    s1, s2 = random_sequences(900, 120, 77)
    tables = R.Tables((1, 3, 4, 2), False)
    assert (R.winner(s1, s2, tables, "cpu", block_elems=block * 120)
            == R.winner(s1, s2, tables, "cpu"))


@pytest.mark.parametrize("seed", range(6))
def test_reference_agrees_with_the_ports_host_oracle(seed):
    """A second witness: the port's numpy engine, at sizes the brute force
    would take long over."""
    from psa_torch.models.search import AlignmentSearchEngine

    w, is_max = CASES[seed]
    s1, s2 = random_sequences(2000 + 37 * seed, 300 + seed, 1000 + seed)
    r = AlignmentSearchEngine(w, is_max, backend="numpy").search(s1, s2)
    got = R.winner(s1, s2, R.Tables(w, is_max), "cpu")
    assert got == (r.offset, r.char_offset, r.sub_code, r.score)


def test_table_dtype_is_int8_for_small_weights():
    assert R.table_dtype(R.Tables((1, 3, 4, 2), False)) == torch.int8
    assert R.table_dtype(R.Tables((1, 300, 4, 2), False)) == torch.int32
