"""Reference-compatible file I/O.

Input: whitespace-delimited tokens — 4 weights, Seq1, Seq2, mode token —
exactly like the fscanf-based parser (cpu_funcs.c:353-368).  Tokens beyond the
first seven are ignored, so files that double as scratchpads (like the bundled
input.txt) parse identically.

Output: ``"%s\\n%d %g"`` with no trailing newline (cpu_funcs.c:373-378).
Python's ``%g`` matches C's for finite doubles.
"""

from __future__ import annotations

import dataclasses

import numpy as np


WEIGHTS_FINITE_ERROR = "weights must be finite (inf/nan rejected)"


@dataclasses.dataclass(frozen=True)
class Query:
    weights: np.ndarray  # (4,) f64
    seq1: str
    seq2: str
    is_max: bool

    MAXIMUM_STR = "maximum"


def parse_input(text: str) -> Query:
    tokens = text.split()
    if len(tokens) < 7:
        raise ValueError(f"input needs >= 7 whitespace-delimited tokens, got {len(tokens)}")
    weights = np.array([float(t) for t in tokens[:4]], dtype=np.float64)
    if not np.isfinite(weights).all():
        # C fscanf %lf accepts inf/nan spellings too, but downstream they
        # would silently corrupt the rank tables and the selection epsilon
        # bands: reject at parse time.
        raise ValueError(WEIGHTS_FINITE_ERROR)
    seq1, seq2 = tokens[4], tokens[5]
    # strcmp(func_type, "maximum") == 0 -> max, anything else -> min
    # (cpu_funcs.c:365).
    is_max = tokens[6] == Query.MAXIMUM_STR
    if len(seq2) > len(seq1):
        raise ValueError("seq2 must not be longer than seq1")
    return Query(weights=weights, seq1=seq1, seq2=seq2, is_max=is_max)


def read_input(path: str) -> Query:
    with open(path, "r") as f:
        return parse_input(f.read())


def parse_cases(text: str) -> list[Query]:
    """Parse every embedded 7-token case record.

    The reference's fscanf parser consumes only the first record
    (cpu_funcs.c:353-368), but its bundled input.txt doubles as a scratchpad
    holding more cases as leftover tokens.  This reads them all: records are
    consumed greedily, 7 whitespace tokens each (4 weights, Seq1, Seq2, mode).
    """
    tokens = text.split()
    cases = []
    i = 0
    while i + 7 <= len(tokens):
        try:
            weights = np.array([float(t) for t in tokens[i: i + 4]],
                               dtype=np.float64)
        except ValueError:
            break  # scratchpad junk after the last complete record
        seq1, seq2, mode = tokens[i + 4], tokens[i + 5], tokens[i + 6]
        # Records after the first must carry a real mode token, otherwise
        # trailing numeric scratchpad junk would fabricate bogus cases.
        # (The FIRST record mirrors read_input/the reference: any token
        # that isn't "maximum" means minimum, cpu_funcs.c:365.)
        if i > 0 and mode not in ("maximum", "minimum"):
            break
        if not np.isfinite(weights).all():
            raise ValueError(f"case {len(cases)}: {WEIGHTS_FINITE_ERROR}")
        if len(seq2) > len(seq1):
            raise ValueError(f"case {len(cases)}: seq2 longer than seq1")
        cases.append(Query(weights=weights, seq1=seq1, seq2=seq2,
                           is_max=mode == Query.MAXIMUM_STR))
        i += 7
    if not cases:
        raise ValueError("no complete 7-token case records found")
    return cases


def read_cases(path: str) -> list[Query]:
    with open(path, "r") as f:
        return parse_cases(f.read())


def format_output(mutant: str, offset: int, score: float) -> str:
    return "%s\n%d %g" % (mutant, offset, score)


def write_output(path: str, mutant: str, offset: int, score: float) -> None:
    with open(path, "w") as f:
        f.write(format_output(mutant, offset, score))
