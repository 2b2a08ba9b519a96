"""Search result data model.

Mirrors the reference's ``Mutant`` struct (mutant.h:6-10: offset, char_offset,
ch) plus the winning score, with a defined no-mutation behavior instead of the
reference's out-of-bounds write (cpu_funcs.c:96-98, SURVEY.md Q3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from psa_torch.core.alphabet import decode, decode_char


class NoMutationFound(Exception):
    """No offset admits any legal substitution (reference would hit UB here)."""


@dataclasses.dataclass(frozen=True)
class SearchResult:
    offset: int          # best alignment offset of Seq2 under Seq1
    char_offset: int     # substituted position within Seq2
    sub_code: int        # code of the substitute character
    score: float         # total alignment score after the substitution

    @property
    def sub_char(self) -> str:
        return decode_char(self.sub_code)

    def mutant(self, seq2: str) -> str:
        """Seq2 with the single substitution applied (cpu_funcs.c:96-98)."""
        return seq2[: self.char_offset] + self.sub_char + seq2[self.char_offset + 1:]

    def mutant_codes(self, codes2: np.ndarray) -> np.ndarray:
        """Encoded Seq2 with the substitution applied (a copy)."""
        out = np.asarray(codes2).copy()
        out[self.char_offset] = self.sub_code
        return out

    def mutant_from_codes(self, codes2: np.ndarray) -> str:
        return decode(self.mutant_codes(codes2))
