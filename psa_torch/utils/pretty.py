"""Alignment rendering — the reference's debug pretty-printer, rebuilt.

Mirrors pretty_print / get_score_and_signs / print_with_offset
(cpu_funcs.c:382-461): prints the sign row, both sequences at the winning
offset, the mutated sequence, before/after scores, and highlights the mutated
column in red (ANSI)."""

from __future__ import annotations

import sys

import numpy as np

from psa_torch.core.alphabet import HYPHEN_CODE, encode
from psa_torch.core.result import SearchResult
from psa_torch.core.tables import _SIGN, SIGN_CHARS, ScoringTables, build_tables

_RED = "\033[0;31m"
_RESET = "\033[0m"


def score_and_signs(codes1: np.ndarray, codes2: np.ndarray,
                    tables: ScoringTables, offset: int) -> tuple[float, str]:
    """Exact f64 score + sign string for one offset (cpu_funcs.c:429-441)."""
    win = codes1[offset: offset + codes2.shape[0]]
    s = tables.sign[win, codes2]
    score = float(tables.pair_w[win, codes2].sum())
    signs = "".join(SIGN_CHARS[k] if k < 4 else " " for k in s)
    return score, signs


def _with_offset(text: str, offset: int, char_offset: int, color: bool) -> str:
    pad = " " * offset
    if not color or char_offset < 0 or char_offset >= len(text):
        return pad + text
    return (pad + text[:char_offset] + _RED + text[char_offset] + _RESET
            + text[char_offset + 1:])


def render(query, result: SearchResult, color: bool = True) -> str:
    """Full explanation block; `query` is a utils.io.Query."""
    tables = build_tables(query.weights, query.is_max)
    c1, c2 = encode(query.seq1), encode(query.seq2)
    mutant = result.mutant(query.seq2)
    cm = encode(mutant)

    before, signs_before = score_and_signs(c1, c2, tables, result.offset)
    after, signs_after = score_and_signs(c1, cm, tables, result.offset)

    mode = "Maximum" if query.is_max else "Minimum"
    if color:
        mode = _RED + mode + _RESET
    lines = [
        f"{mode} problem",
        "Weights: " + " ".join("%g" % w for w in query.weights),
        "",
        "Original Score: %g" % before,
        _with_offset(signs_before, result.offset, result.char_offset, color),
        _with_offset(query.seq2, result.offset, result.char_offset, color),
        query.seq1,
        _with_offset(mutant, result.offset, result.char_offset, color),
        _with_offset(signs_after, result.offset, result.char_offset, color),
        "Mutation Score: %g" % after,
        "Seq offset=%3d, Char offset=%3d" % (result.offset, result.char_offset),
    ]
    return "\n".join(lines)


def pretty_print(query, result: SearchResult, file=None) -> None:
    """Print `render` to `file` (the current sys.stdout by default), in color
    on a terminal."""
    if file is None:
        file = sys.stdout
    color = hasattr(file, "isatty") and file.isatty()
    print(render(query, result, color=color), file=file)


def render_sign_table() -> str:
    """The 27x27 sign matrix (A-Z + '-'), like print_hash (cpu_funcs.c:322-349)
    — without the reference's 26x26 overflow bug."""
    chars = [chr(ord("A") + i) for i in range(26)] + ["-"]
    codes = list(range(26)) + [HYPHEN_CODE]
    lines = ["   " + " ".join(chars), "   " + "_" * (2 * len(chars) - 1)]
    for ci, c in zip(codes, chars):
        row = " ".join(SIGN_CHARS[int(_SIGN[ci, cj])] for cj in codes)
        lines.append(f"{c} |{row}")
    return "\n".join(lines)
