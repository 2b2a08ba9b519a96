"""The benchmark's input generator, frozen.

A copy of `psa_torch.utils.generator.random_sequences`: the same seed gives
the same two sequences (uniform letters A-Z, an optional share of '-'), so
the inputs of a cell stay where they are whatever a later change does to
the program's own generator.  The decode is a byte table instead of a
string join; the characters are the same.
"""

from __future__ import annotations

import numpy as np

_LETTERS = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ-", np.uint8)


def random_sequences(n1: int, n2: int, seed=0,
                     hyphen_p: float = 0.0) -> tuple[str, str]:
    """(seq1, seq2) of lengths n1 >= n2 from `np.random.default_rng(seed)`:
    n1 draws of `integers(0, 26)`, then n2 more (and, with hyphen_p > 0,
    after each sequence's letters a `random(n)` draw that turns a share of
    them into '-')."""
    if n2 > n1:
        raise ValueError("n2 must be <= n1")
    rng = np.random.default_rng(seed)

    def one(n):
        codes = rng.integers(0, 26, size=n, dtype=np.int32)
        if hyphen_p > 0:
            codes[rng.random(n) < hyphen_p] = 26
        return _LETTERS[codes].tobytes().decode("ascii")

    return one(n1), one(n2)


def query_seed(seed: int, index: int) -> list:
    """The entropy of query `index` of a run with `seed`: distinct queries
    for every (seed, index), any whole seed (negative ones wrap to 64
    bits)."""
    return [int(seed) % (1 << 64), int(index)]


def make_calls(seed: int, calls: int, per_call: int, n1: int, n2: int,
               shared_seq1: bool = False) -> list:
    """`calls` lists of `per_call` (seq1, seq2) queries, all distinct, drawn
    from the seed; with shared_seq1 the queries of one call share the
    first query's Seq1."""
    out = []
    for c in range(calls):
        call = []
        for q in range(per_call):
            s1, s2 = random_sequences(n1, n2, query_seed(seed, c * per_call + q))
            if shared_seq1 and call:
                s1 = call[0][0]
            call.append((s1, s2))
        out.append(call)
    return out
