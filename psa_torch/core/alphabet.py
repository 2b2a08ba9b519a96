"""Alphabet encoding for the alignment engine.

Characters are mapped to small integer codes so that every pair-wise rule can
live in a precomputed (NCODES x NCODES) table:

    'A'..'Z' -> 0..25
    '-'      -> 26   (HYPHEN_CODE; special-cased analytically by the rules)
    any other input char -> 27 (OTHER_CODE; out-of-range semantics)
    padding  -> 28   (PAD_CODE; fully inert: scores 0 with everything)

The reference treats out-of-range characters as sign '\\0' weighing zero
(cuda_funcs.cu:428-429, cuda_funcs.cu:451) but checks hyphens FIRST
(cuda_funcs.cu:426-427), so '-' vs an out-of-range char is SPACE.  PAD_CODE is
distinct from OTHER_CODE because padding must be inert against *every* code,
including hyphen.
"""

from __future__ import annotations

import numpy as np

NUM_LETTERS = 26
HYPHEN_CODE = 26
OTHER_CODE = 27
PAD_CODE = 28
NCODES = 29
# Table dimension: the fused code table is (NCODES_PAD, NCODES_PAD).
NCODES_PAD = 32

_ENC8 = np.full(256, OTHER_CODE, np.uint8)     # byte -> code
_ENC8[ord("A"): ord("A") + NUM_LETTERS] = np.arange(NUM_LETTERS)
_ENC8[ord("-")] = HYPHEN_CODE
_TRANS8 = _ENC8.tobytes()           # the same table for bytes.translate
_OTHER8 = bytes([OTHER_CODE])

_DEC = np.array([chr(ord("A") + i) for i in range(NUM_LETTERS)] + ["-", "?", "."])


def _ascii(seq: str | bytes) -> bytes:
    """A sequence's bytes: one byte a character, a non-ASCII one as '?'."""
    if isinstance(seq, str):
        return seq.encode("ascii", errors="replace")
    return seq


def encode_checked(seq: str | bytes) -> tuple[np.ndarray, bool]:
    """One pass from a sequence to the kernels' uint8 codes, and whether
    every character is in the alphabet (A-Z, '-'), read from that pass:
    the native library's checked encode when it builds, else
    `bytes.translate` through the same table and a search for OTHER_CODE.
    The codes are `encode`'s, the flag `validate`'s."""
    from psa_torch import native    # the library's module imports this one

    raw = _ascii(seq)
    if native.available():
        codes, ok = native.encode_checked_native([raw], len(raw))
        return codes[0], bool(ok[0])
    codes = bytearray(raw).translate(_TRANS8)
    return np.frombuffer(codes, np.uint8), _OTHER8 not in codes


def encode(seq: str | bytes) -> np.ndarray:
    """Encode a sequence string into int32 codes."""
    return encode_checked(seq)[0].astype(np.int32)


def decode(codes: np.ndarray) -> str:
    """Decode int codes back into a string ('?' = OTHER, '.' = PAD)."""
    codes = np.asarray(codes)
    return "".join(_DEC[np.clip(codes, 0, PAD_CODE)])


def decode_char(code: int) -> str:
    return _DEC[min(int(code), PAD_CODE)]


def pad_codes(codes: np.ndarray, length: int) -> np.ndarray:
    """Right-pad a code array with PAD_CODE to `length` (int32)."""
    codes = np.asarray(codes, dtype=np.int32)
    if codes.shape[0] > length:
        raise ValueError(f"sequence length {codes.shape[0]} exceeds padded length {length}")
    out = np.full(length, PAD_CODE, dtype=np.int32)
    out[: codes.shape[0]] = codes
    return out


def validate(seq: str | bytes) -> bool:
    """True when every character is in the engine's defined alphabet (A-Z, '-')."""
    return encode_checked(seq)[1]


def encode_batch_checked(seqs,
                         length: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode many sequences into one PAD-padded (len(seqs), length) uint8
    array (the kernels' input type, so the upload needs no cast), with each
    row's validity (A-Z and '-' only) read from the same pass: one C pass
    of the native library when it builds, else a table gather and an
    OTHER_CODE search a row; the same table and the same bytes either
    way."""
    from psa_torch import native    # the library's module imports this one

    raws = [_ascii(s) for s in seqs]
    if raws and max(map(len, raws)) > length:
        i = max(range(len(raws)), key=lambda i: len(raws[i]))
        raise ValueError(
            f"sequence length {len(seqs[i])} exceeds padded length {length}")
    if native.available():
        return native.encode_checked_native(raws, length)
    buf = np.full((len(raws), length), PAD_CODE, np.uint8)
    ok = np.ones(len(raws), bool)
    for i, raw in enumerate(raws):
        row = buf[i, : len(raw)]
        row[:] = _ENC8[np.frombuffer(raw, np.uint8)]
        ok[i] = not (row == OTHER_CODE).any()
    return buf, ok


def validate_batch(seqs) -> np.ndarray:
    """Per-sequence validity flags (A-Z and '-' only) for many sequences in
    one vectorized pass."""
    n = len(seqs)
    joined = "".join(seqs).encode("ascii", errors="replace")
    if not joined:
        return np.ones(n, bool)
    flags = _ENC8[np.frombuffer(joined, np.uint8)] > HYPHEN_CODE
    if not flags.any():                 # the common case: everything valid
        return np.ones(n, bool)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    bad = np.concatenate([[0], np.cumsum(flags)])
    ends = np.cumsum(lens)
    return bad[ends] == bad[ends - lens]


ALPHABET_ERROR = ("sequences must contain only A-Z and '-' "
                  "(pass --lenient to accept reference-UB inputs)")
