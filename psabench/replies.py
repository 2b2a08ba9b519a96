"""The strict decoder of a serve reply: one reply line back to the winner
tuple that `check.py` compares with the plain reference's.

The serve protocol answers a query line `w1 w2 w3 w4 Seq1 Seq2 mode` with
`<offset> <score %g> <mutant>`, the upstream's output.txt fields on one
line, or `-1 inf <Seq2>` (`-inf` in `maximum` mode) when no offset admits a
substitution.  The mutant is Seq2 with exactly one position changed, at the
same length; that position is the winner's char_offset and its character
the substitute.  The score is an integer (integer weights), and its
magnitude is at most the largest weight times the Seq2 length, 4 x 250,000
= 10^6 at the cells' sizes: `%g`'s six significant digits print every such
integer exactly (10^6 itself as `1e+06`), so the parsed float is the score.

Any other reply (an `error ...` line, a field out of form, a mutant of
another length or with no or several changes, a substitute outside the
alphabet) decodes to a value that never equals a reference answer.
"""

from __future__ import annotations

import math
import re

import numpy as np

# the substitute's code, as the program and the reference number them
ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZ-"
_OFFSET = re.compile(r"0|[1-9][0-9]*")


def malformed(reply: str) -> tuple:
    """What a reply out of form decodes to: a pair of strings, never a
    reference answer (a 4-tuple of numbers or None)."""
    return ("malformed", reply[:80])


def decode(reply: str, seq2: str):
    """(offset, char_offset, sub_code, score), None for "no offset admits a
    substitution", or `malformed(reply)`."""
    parts = reply.rstrip("\n").split(" ")
    if len(parts) != 3:
        return malformed(reply)
    off_s, score_s, mutant = parts
    if off_s == "-1":
        if score_s in ("inf", "-inf") and mutant == seq2:
            return None
        return malformed(reply)
    if not _OFFSET.fullmatch(off_s):
        return malformed(reply)
    try:
        score = float(score_s)
    except ValueError:
        return malformed(reply)
    # the score as `%g` prints it, and nothing else
    if not math.isfinite(score) or "%g" % score != score_s:
        return malformed(reply)
    if len(mutant) != len(seq2) or not mutant.isascii():
        return malformed(reply)
    changed = np.flatnonzero(np.frombuffer(mutant.encode("ascii"), np.uint8)
                             != np.frombuffer(seq2.encode("ascii"), np.uint8))
    if changed.shape[0] != 1 or mutant[changed[0]] not in ALPHABET:
        return malformed(reply)
    i = int(changed[0])
    return int(off_s), i, ALPHABET.index(mutant[i]), score
