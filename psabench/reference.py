"""The plain reference that decides `correct`.

It answers what the program answers, from the same strings, by the upstream
program's rules (GuyKabiri/Parallel-Sequence-Alignment: README.md, def.h,
cpu_funcs.c, cuda_funcs.cu): score Seq2 at every offset under Seq1 as the sum
of its pairs' sign weights, take at each offset the single substitution that
improves the score most (the first position where it does, cpu_funcs.c:
287-288's strict comparison), and answer the offset with the best total, the
lowest offset on a tie (cuda_funcs.cu:290-307).

It imports nothing of the program.  Its tables are built here again from the
rules (a frozen transcription of the upstream's sign groups and substitute
scans), and its sweep is plain PyTorch: for each block of offsets one gather
of the pair weights and one of the substitution gains, a sum and a min.  It
needs integer weights: every total is then an integer that int64 holds
exactly, summed in any order, so the score equals the upstream's sequential
double sum bit for bit.

`winner(..., position="last")` and `dtype=torch.float32` serve the control
(control.py) alone: the reference is the default of each, integer tables
(int8 for these weights) and sums in int64.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_LETTERS = 26
HYPHEN = 26
OTHER = 27
NCODES = 28

AST, COLON, DOT, SPACE, NONE = 0, 1, 2, 3, 4

# cpu_funcs.c:19-20 (the code's groups, not the README's)
CONSERVATIVE = ("NDEQ", "NEQK", "STA", "MILV", "QHRK", "NHQK", "FYW", "HY",
                "MILF")
SEMI_CONSERVATIVE = ("SAG", "ATV", "CSA", "SGND", "STPA", "STNK", "NEQHRK",
                     "NDEQHK", "SNDEQK", "HFY", "FVLIM")


def encode(seq: str) -> np.ndarray:
    """'A'-'Z' -> 0-25, '-' -> 26, anything else -> 27 (int64)."""
    raw = np.frombuffer(seq.encode("ascii", errors="replace"), np.uint8)
    out = np.full(raw.shape, OTHER, np.int64)
    letter = (raw >= ord("A")) & (raw <= ord("Z"))
    out[letter] = raw[letter] - ord("A")
    out[raw == ord("-")] = HYPHEN
    return out


def sign_table() -> np.ndarray:
    """(NCODES, NCODES) sign class of a pair (cuda_funcs.cu:424-439): the
    hyphen is checked before the letter range."""
    cons = [{ord(c) - 65 for c in g} for g in CONSERVATIVE]
    semi = [{ord(c) - 65 for c in g} for g in SEMI_CONSERVATIVE]
    sign = np.full((NCODES, NCODES), NONE, np.int64)
    for a in range(NCODES):
        for b in range(NCODES):
            if a == HYPHEN and b == HYPHEN:
                sign[a, b] = AST
            elif HYPHEN in (a, b):
                sign[a, b] = SPACE
            elif a >= NUM_LETTERS or b >= NUM_LETTERS:
                sign[a, b] = NONE
            elif a == b:
                sign[a, b] = AST
            elif any(a in g and b in g for g in cons):
                sign[a, b] = COLON
            elif any(a in g and b in g for g in semi):
                sign[a, b] = DOT
            else:
                sign[a, b] = SPACE
    return sign


def _class_weight(cls: int, w) -> int:
    """cuda_funcs.cu:442-452: +w1 for '*', -w2, -w3, -w4, 0 out of range."""
    return (w[0], -w[1], -w[2], -w[3], 0)[cls]


def _first_letter(sign, by: int, want: int, rest: int) -> int:
    """cuda_funcs.cu:412-421: the first letter A-Z whose sign with `by` is
    `want` and which is not conservative with `rest`; -1 when none."""
    for ch in range(NUM_LETTERS):
        if sign[by, ch] == want and sign[rest, ch] != COLON:
            return ch
    return -1


def _pick(is_max: bool, d1, s1: int, d2, s2: int) -> int:
    """cuda_funcs.cu:396-409: the first candidate unless the second is
    strictly better; whichever exists."""
    if (d1 >= d2) if is_max else (d1 <= d2):
        if s1 >= 0:
            return s1
    return s2 if s2 >= 0 else s1


def substitute(sign, c1: int, c2: int, w, is_max: bool) -> int:
    """The upstream's substitute for pair (c1, c2) (cuda_funcs.cu:310-393),
    -1 when none."""
    cls = int(sign[c1, c2])
    if cls == NONE:
        return -1
    dot = _first_letter(sign, c1, DOT, c2)
    space = _first_letter(sign, c1, SPACE, c2)
    if is_max:
        if cls in (DOT, SPACE):
            return c1
        if cls == AST:
            return _pick(True, -w[0] - w[2], dot, -w[0] - w[3], space)
        # a colon pair never takes a colon substitute in maximum mode
        return _pick(True, w[1] - w[2], dot, w[1] - w[3], space)
    colon = _first_letter(sign, c1, COLON, c2)
    if cls == AST:
        return _pick(False, -w[0] - w[2], dot, -w[0] - w[3], space)
    if cls == COLON:
        return _pick(False, w[1] - w[2], dot, w[1] - w[3], space)
    if cls == DOT:
        s = _pick(False, w[2] - w[1], colon, w[2] - w[3], space)
    else:
        s = _pick(False, w[3] - w[1], colon, w[3] - w[2], dot)
    return c1 if s < 0 else s     # the identity when nothing else is legal


class Tables:
    """The pair weight, substitute and gain of every code pair, for integer
    weights and a mode."""

    def __init__(self, weights, is_max: bool):
        w = [float(x) for x in weights]
        if len(w) != 4 or any(x != int(x) or abs(x) > 2 ** 20 for x in w):
            raise ValueError("the reference takes four integer weights "
                             f"(|w| <= 2**20), got {weights}")
        w = [int(x) for x in w]
        self.weights, self.is_max = w, bool(is_max)
        sign = sign_table()
        self.pair_w = np.array([[_class_weight(int(sign[a, b]), w)
                                 for b in range(NCODES)]
                                for a in range(NCODES)], np.int64)
        self.sub = np.full((NCODES, NCODES), -1, np.int64)
        self.has_sub = np.zeros((NCODES, NCODES), bool)
        self.gain = np.zeros((NCODES, NCODES), np.int64)
        for a in range(NCODES):
            for b in range(NCODES):
                s = substitute(sign, a, b, w, self.is_max)
                if s >= 0:
                    self.sub[a, b] = s
                    self.has_sub[a, b] = True
                    # the applied delta, from the real sign of the new pair
                    self.gain[a, b] = (_class_weight(int(sign[a, s]), w)
                                       - self.pair_w[a, b])

    def worst_gain(self) -> int:
        """A gain no pair reaches: what a pair without a substitute reads."""
        big = int(np.abs(self.gain).max()) + 1
        return -big if self.is_max else big


def _block_rows(n2: int, block_elems: int) -> int:
    return max(1, block_elems // max(n2, 1))


def table_dtype(tables: Tables):
    """The narrowest integer type that holds every weight and gain: int8
    for the usual small weights, so each gather writes a byte a pair."""
    top = max(int(np.abs(tables.pair_w).max()), abs(tables.worst_gain()))
    return torch.int8 if top <= 127 else torch.int32


def offset_totals(seq1: str, seq2: str, tables: Tables, device,
                  block_elems: int = 1 << 27,
                  dtype=None) -> tuple[np.ndarray, np.ndarray]:
    """Per offset: the total after its best substitution (float64, an exact
    integer) and whether any substitution is legal there.  On `device`, one
    block of offsets at a time: each block's Seq1 windows are a view, their
    pairs' weights and gains two gathers of (rows, n2) in `dtype` (None:
    `table_dtype`), summed in int64 for an integer dtype and in `dtype`
    otherwise."""
    if dtype is None:
        dtype = table_dtype(tables)
    c1 = torch.from_numpy(encode(seq1)).to(device)
    c2 = torch.from_numpy(encode(seq2)).to(device)
    n1, n2 = c1.shape[0], c2.shape[0]
    noff = n1 - n2 + 1
    if n2 == 0 or noff <= 0:
        raise ValueError("need 0 < len(seq2) <= len(seq1)")
    worst = tables.worst_gain()
    gain = np.where(tables.has_sub, tables.gain, worst)
    # column i of these holds the weight and gain of (a, seq2[i]) for each a
    w_col = torch.from_numpy(tables.pair_w).to(device, dtype)[:, c2]
    g_col = torch.from_numpy(gain).to(device, dtype)[:, c2]
    windows = c1.unfold(0, n2, 1)                     # (noff, n2), a view
    acc = torch.int64 if not dtype.is_floating_point else dtype
    totals = torch.empty(noff, dtype=acc, device=device)
    best = torch.empty(noff, dtype=dtype, device=device)
    rows = _block_rows(n2, block_elems)
    for o in range(0, noff, rows):
        idx = windows[o: o + rows]
        totals[o: o + rows] = torch.gather(w_col, 0, idx).sum(1, dtype=acc)
        g = torch.gather(g_col, 0, idx)
        best[o: o + rows] = g.amax(1) if tables.is_max else g.amin(1)
    legal = (best != worst).cpu().numpy()
    return (totals + best.to(acc)).cpu().numpy().astype(np.float64), legal


def winner(seq1: str, seq2: str, tables: Tables, device,
           block_elems: int = 1 << 27, position: str = "first",
           dtype=None):
    """(offset, char_offset, sub_code, score) of the best single
    substitution, or None when no offset admits one."""
    totals, legal = offset_totals(seq1, seq2, tables, device, block_elems,
                                  dtype)
    if not legal.any():
        return None
    masked = np.where(legal, totals, -np.inf if tables.is_max else np.inf)
    off = int(np.argmax(masked) if tables.is_max else np.argmin(masked))
    c1, c2 = encode(seq1), encode(seq2)
    a, b = c1[off: off + c2.shape[0]], c2
    gains = np.where(tables.has_sub[a, b], tables.gain[a, b],
                     tables.worst_gain())
    best = gains.max() if tables.is_max else gains.min()
    hits = np.nonzero(gains == best)[0]
    i = int(hits[0] if position == "first" else hits[-1])
    score = (float(masked[off]) if dtype is not None
             and dtype.is_floating_point
             else float(int(tables.pair_w[a, b].sum()) + int(best)))
    return off, i, int(tables.sub[a[i], b[i]]), float(score)
