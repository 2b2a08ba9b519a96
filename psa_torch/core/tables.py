"""Precomputed scoring/substitution tables — the heart of the design.

`build_tables` and `ScoringTables` are a verbatim copy of the JAX package's
pure-numpy construction (f64 on the host); `tables_from_arrays` carries a
table set built there across as plain arrays, and `device_tables` gives the
torch tensors the device path reads.

The reference recomputes substitution candidates per (offset, position) with
nested character scans (reference: cuda_funcs.cu:310-421 called from
cpu_funcs.c:280 and cuda_funcs.cu:176).  Everything there depends only on the
character pair (c1, c2) and the run configuration (weights, mode), so this
module hoists ALL of it into tiny constant tables built once on the host:

* ``sign``      (28, 28) int8  — pair sign class (cuda_funcs.cu:424-439, 495-502)
* ``pair_w``    (28, 28) f64   — sign weight contribution (cuda_funcs.cu:442-452)
* ``sub``       (28, 28) int8  — best substitute char code, -1 when none
                                 (cuda_funcs.cu:310-421)
* ``diff``      (28, 28) f64   — exact score delta of that substitution
* ``rank``      (28, 28) int8  — substitution quality rank; ranks order the
                                 *distinct f64 diff values* so a higher rank is
                                 strictly better for the mode, reproducing the
                                 reference's strict `>` / `<` comparison at
                                 cpu_funcs.c:287-288 under parallel reductions
* ``code``      (32, 32) int8  — fused device table: 0 = inert (pad /
                                 out-of-range), else 1 + cls + 4*(rank+1)

Device kernels gather/matmul only `code`; exact f64 arithmetic happens on the
host from integer sign-class counts, so device results are bit-deterministic.

Semantic quirks replicated on purpose (SURVEY.md §7.3):
* groups come from the code, not the README (`SGND` semi-conservative group),
* MAX mode never considers colon->colon substitutions even when beneficial
  (cuda_funcs.cu:330-344),
* MIN mode '.'/'_' positions fall back to the score-raising identity
  substitution c1 when no candidate exists (cuda_funcs.cu:385-392),
* substitute-character ties break alphabetically (first match of the A..Z scan
  at cuda_funcs.cu:414-420),
* a substitution is only legal when no conservative group contains both the
  original and the substitute (cuda_funcs.cu:417).

Bugs NOT replicated (SURVEY.md Q2): the reference's 26x26 table overflow/race
in fill_hash (cpu_funcs.c:304-318) — we build a clean 28x28 table.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from psa_torch.core.alphabet import (
    HYPHEN_CODE,
    NCODES,
    NCODES_PAD,
    NUM_LETTERS,
    PAD_CODE,
)
from psa_torch.utils import spans

# Sign classes (device encoding; the reference uses chars '*' ':' '.' '_').
SIGN_AST = 0
SIGN_COLON = 1
SIGN_DOT = 2
SIGN_SPACE = 3
SIGN_NONE = 4  # out-of-range / padding; weighs 0 (cuda_funcs.cu:451)

SIGN_CHARS = "*:._"

NOT_FOUND = -1

# Group definitions exactly as coded (cpu_funcs.c:19-20; README differs — the
# code wins, see SURVEY.md Q1).
CONSERVATIVE_GROUPS = (
    "NDEQ", "NEQK", "STA", "MILV", "QHRK", "NHQK", "FYW", "HY", "MILF",
)
SEMI_CONSERVATIVE_GROUPS = (
    "SAG", "ATV", "CSA", "SGND", "STPA", "STNK",
    "NEQHRK", "NDEQHK", "SNDEQK", "HFY", "FVLIM",
)


def _build_sign_table() -> np.ndarray:
    """(28, 28) int8 sign-class table over character codes."""
    cons = [frozenset(ord(c) - ord("A") for c in g) for g in CONSERVATIVE_GROUPS]
    semi = [frozenset(ord(c) - ord("A") for c in g) for g in SEMI_CONSERVATIVE_GROUPS]

    sign = np.full((NCODES, NCODES), SIGN_NONE, dtype=np.int8)
    for a in range(NCODES):
        for b in range(NCODES):
            # PAD is our own sentinel: inert against everything (not in the
            # reference, whose shapes are dynamic).
            if a == PAD_CODE or b == PAD_CODE:
                sign[a, b] = SIGN_NONE
            # Hyphen short-circuits before the range check (cuda_funcs.cu:426-427),
            # so '-' vs an out-of-range char is SPACE.
            elif a == HYPHEN_CODE and b == HYPHEN_CODE:
                sign[a, b] = SIGN_AST
            elif a == HYPHEN_CODE or b == HYPHEN_CODE:
                sign[a, b] = SIGN_SPACE
            elif a >= NUM_LETTERS or b >= NUM_LETTERS:
                sign[a, b] = SIGN_NONE
            elif a == b:
                sign[a, b] = SIGN_AST
            elif any(a in g and b in g for g in cons):
                sign[a, b] = SIGN_COLON
            elif any(a in g and b in g for g in semi):
                sign[a, b] = SIGN_DOT
            else:
                sign[a, b] = SIGN_SPACE
    return sign


_SIGN = _build_sign_table()


def pair_sign(a: int, b: int) -> int:
    """Sign class of a code pair (table lookup; mirrors get_hashtable_sign)."""
    return int(_SIGN[a, b])


def sign_weight(sign: int, w) -> float:
    """Score contribution of a sign class (cuda_funcs.cu:442-452)."""
    if sign == SIGN_AST:
        return float(w[0])
    if sign == SIGN_COLON:
        return -float(w[1])
    if sign == SIGN_DOT:
        return -float(w[2])
    if sign == SIGN_SPACE:
        return -float(w[3])
    return 0.0


def _substitute_by_sign_with_restrictions(by: int, want_sign: int, rest: int) -> int:
    """First letter (A..Z scan => alphabetical tie-break) whose sign with `by`
    is `want_sign` and which is not conservative with `rest`
    (cuda_funcs.cu:412-421)."""
    for ch in range(NUM_LETTERS):
        if _SIGN[by, ch] == want_sign and _SIGN[rest, ch] != SIGN_COLON:
            return ch
    return NOT_FOUND


def _optimal_substitute(is_max: bool, d1: float, s1: int, d2: float, s2: int) -> int:
    """cuda_funcs.cu:396-409 — prefer diff1 on ties; fall back when missing."""
    if (is_max and d1 >= d2) or (not is_max and d1 <= d2):
        if s1 != NOT_FOUND:
            return s1
    if s2 != NOT_FOUND:
        return s2
    return s1


def _max_substitute(c1: int, c2: int, sign: int, w) -> int:
    """cuda_funcs.cu:320-345. Note: colon->colon (diff 0) is deliberately never
    considered — observable behavior the build must keep (SURVEY.md Q5)."""
    if sign in (SIGN_DOT, SIGN_SPACE):
        return c1  # identity substitution: always legal, always best here
    if sign == SIGN_AST:
        dot_diff = -w[0] - w[2]
        space_diff = -w[0] - w[3]
    elif sign == SIGN_COLON:
        dot_diff = w[1] - w[2]
        space_diff = w[1] - w[3]
    else:  # SIGN_NONE: undefined behavior in the reference; we define "no sub"
        return NOT_FOUND
    dot_sub = _substitute_by_sign_with_restrictions(c1, SIGN_DOT, c2)
    space_sub = _substitute_by_sign_with_restrictions(c1, SIGN_SPACE, c2)
    return _optimal_substitute(True, dot_diff, dot_sub, space_diff, space_sub)


def _min_substitute(c1: int, c2: int, sign: int, w) -> int:
    """cuda_funcs.cu:348-393 (incl. the c1 fallback for '.'/'_' pairs)."""
    if sign == SIGN_NONE:
        return NOT_FOUND
    colon_sub = _substitute_by_sign_with_restrictions(c1, SIGN_COLON, c2)
    dot_sub = _substitute_by_sign_with_restrictions(c1, SIGN_DOT, c2)
    space_sub = _substitute_by_sign_with_restrictions(c1, SIGN_SPACE, c2)

    if sign == SIGN_AST:
        d1, s1 = -w[0] - w[2], dot_sub
        d2, s2 = -w[0] - w[3], space_sub
    elif sign == SIGN_COLON:
        d1, s1 = w[1] - w[2], dot_sub
        d2, s2 = w[1] - w[3], space_sub
    elif sign == SIGN_DOT:
        d1, s1 = w[2] - w[1], colon_sub
        d2, s2 = w[2] - w[3], space_sub
    else:  # SIGN_SPACE
        d1, s1 = w[3] - w[1], colon_sub
        d2, s2 = w[3] - w[2], dot_sub

    if sign in (SIGN_AST, SIGN_COLON):
        return _optimal_substitute(False, d1, s1, d2, s2)

    sub = _optimal_substitute(False, d1, s1, d2, s2)
    if sub == NOT_FOUND:
        return c1  # asterisk substitution always possible (cuda_funcs.cu:385-392)
    return sub


def get_substitute(c1: int, c2: int, w, is_max: bool) -> int:
    """Best single-character substitute for pair (c1, c2); cuda_funcs.cu:310-317."""
    sign = int(_SIGN[c1, c2])
    return _max_substitute(c1, c2, sign, w) if is_max else _min_substitute(c1, c2, sign, w)


@dataclasses.dataclass(frozen=True)
class ScoringTables:
    """All constant tables for one (weights, mode) configuration."""

    weights: np.ndarray          # (4,) f64, as parsed
    is_max: bool
    sign: np.ndarray             # (28, 28) int8
    pair_w: np.ndarray           # (28, 28) f64
    sub: np.ndarray              # (28, 28) int8, -1 = no substitution
    diff: np.ndarray             # (28, 28) f64, NaN where no substitution
    rank: np.ndarray             # (28, 28) int8, -1 = no substitution
    diff_vals: np.ndarray        # (R,) f64; higher rank index = strictly better
    code: np.ndarray             # (32, 32) int8 fused device table

    @property
    def num_ranks(self) -> int:
        return int(self.diff_vals.shape[0])

    @property
    def w_signed(self) -> np.ndarray:
        """(4,) f64 — per-sign-class contribution (+w1, -w2, -w3, -w4)."""
        w = self.weights
        return np.array([w[0], -w[1], -w[2], -w[3]], dtype=np.float64)

    def score_from_counts(self, counts: np.ndarray) -> np.ndarray:
        """Exact f64 offset score from integer sign-class counts.

        score = N0*w1 - N1*w2 - N2*w3 - N3*w4 (README.md:19). Counts are exact
        integers, so this is deterministic regardless of device parallelism.
        """
        counts = np.asarray(counts, dtype=np.float64)
        ws = self.w_signed
        return (((counts[..., 0] * ws[0]) + (counts[..., 1] * ws[1]))
                + (counts[..., 2] * ws[2])) + (counts[..., 3] * ws[3])


_TABLES_CACHE: dict = {}


def build_tables_cached(weights, is_max: bool) -> ScoringTables:
    """Memoized `build_tables` — construction costs ~12ms of pure Python
    (the 29x29 substitution scans), which the serving loop otherwise pays
    once per chunk per bucket.  Safe to share: ScoringTables is a frozen
    dataclass and every consumer treats the arrays as constants."""
    key = (tuple(np.asarray(weights, np.float64).tolist()), bool(is_max))
    t = _TABLES_CACHE.get(key)
    if t is None:
        t = _TABLES_CACHE[key] = build_tables(weights, is_max)
    return t


def build_tables(weights, is_max: bool) -> ScoringTables:
    """Build all constant tables for one configuration (pure NumPy, f64)."""
    w = np.asarray(weights, dtype=np.float64)
    assert w.shape == (4,)
    if not np.isfinite(w).all():
        # inf/nan weights would produce inf/NaN diff values, breaking the
        # rank construction below and every selection epsilon band — the
        # parse layer rejects them too (utils/io.parse_input), this is the
        # API-surface backstop (search_batch / AlignmentSearchEngine)
        raise ValueError("weights must be finite (inf/nan rejected)")

    sign = _SIGN.copy()

    pair_w = np.zeros((NCODES, NCODES), dtype=np.float64)
    for a in range(NCODES):
        for b in range(NCODES):
            pair_w[a, b] = sign_weight(int(sign[a, b]), w)

    sub = np.full((NCODES, NCODES), NOT_FOUND, dtype=np.int8)
    diff = np.full((NCODES, NCODES), np.nan, dtype=np.float64)
    for c1 in range(NCODES):
        for c2 in range(NCODES):
            s = get_substitute(c1, c2, w, is_max)
            if s == NOT_FOUND:
                continue
            sub[c1, c2] = s
            # Actual applied delta, recomputed from the real sign of the new
            # pair exactly like cpu_funcs.c:285 / cuda_funcs.cu:180.
            diff[c1, c2] = sign_weight(int(sign[c1, s]), w) - pair_w[c1, c2]

    # Rank distinct f64 diff values so "higher rank = strictly better".
    finite = np.unique(diff[~np.isnan(diff)])
    if is_max:
        diff_vals = finite  # ascending: larger diff = better
    else:
        diff_vals = finite[::-1].copy()  # descending: smaller diff = better

    rank = np.full((NCODES, NCODES), NOT_FOUND, dtype=np.int8)
    val_to_rank = {v: i for i, v in enumerate(diff_vals.tolist())}
    for c1 in range(NCODES):
        for c2 in range(NCODES):
            d = diff[c1, c2]
            if not np.isnan(d):
                rank[c1, c2] = val_to_rank[float(d)]

    # Fused device code: 0 = inert; else 1 + cls + 4*(rank+1).
    code = np.zeros((NCODES_PAD, NCODES_PAD), dtype=np.int8)
    for c1 in range(NCODES):
        for c2 in range(NCODES):
            cls = int(sign[c1, c2])
            if cls == SIGN_NONE:
                continue
            code[c1, c2] = 1 + cls + 4 * (int(rank[c1, c2]) + 1)
    assert code.max() < 127

    return ScoringTables(
        weights=w, is_max=bool(is_max), sign=sign, pair_w=pair_w,
        sub=sub, diff=diff, rank=rank, diff_vals=diff_vals, code=code,
    )


_FIELDS = tuple(f.name for f in dataclasses.fields(ScoringTables))


def tables_from_arrays(**fields) -> ScoringTables:
    """A `ScoringTables` from its fields given as plain arrays — how a table
    set built elsewhere (the JAX package's `build_tables`, a saved file)
    carries across: `weights`, `is_max`, `sign`, `pair_w`, `sub`, `diff`,
    `rank`, `diff_vals`, `code`, each converted to the dtype built here."""
    if set(fields) != set(_FIELDS):
        raise ValueError(f"tables_from_arrays needs exactly the fields {_FIELDS}, "
                         f"got {sorted(fields)}")
    dtypes = {"weights": np.float64, "sign": np.int8, "pair_w": np.float64,
              "sub": np.int8, "diff": np.float64, "rank": np.int8,
              "diff_vals": np.float64, "code": np.int8}
    out = {k: np.array(v, dtype=dtypes[k]) for k, v in fields.items()
           if k != "is_max"}
    return ScoringTables(is_max=bool(fields["is_max"]), **out)


def f32_band_epsilon(tables: ScoringTables, l2p: int) -> float:
    """Bound on |f32 keyed total - exact f64 total| for the device ranking.

    counts <= l2p, weights/diffs bounded; the f32 sum performs ~6 roundings
    on values bounded by S = l2p*max|w| + max|diff|; 16x is headroom.  Any
    offset whose exact total ties the exact best lies within this band of
    the f32 best, so top-k + band-count makes the device ranking *checkably*
    exact: if more than k candidates fall in the band the host falls back.
    """
    max_w = float(np.max(np.abs(tables.w_signed)))
    max_d = float(np.max(np.abs(tables.diff_vals))) if tables.diff_vals.size else 0.0
    s = l2p * max_w + max_d
    return 16.0 * np.float32(np.finfo(np.float32).eps) * max(s, 1.0)


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """The tensors the device path reads for one (weights, mode)."""

    tables: ScoringTables
    code: "torch.Tensor"     # (32, 32) int8 fused code table, [c1][c2]
    w32: "torch.Tensor"      # (4,) f32 signed class weights
    diff32: "torch.Tensor"   # (num_ranks + 1,) f32 rank -> diff, 0 appended
    # values derived once and kept: ("eps", l2p) -> eps; what a kernel
    # wrapper reads on every call (ops/epilogue.py)
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def is_max(self) -> bool:
        return self.tables.is_max

    def eps(self, l2p: int) -> float:
        """The f32 near-tie band half-width for padded Seq2 length l2p,
        computed once per l2p (every device call reads it)."""
        e = self._memo.get(("eps", l2p))
        if e is None:
            e = self._memo["eps", l2p] = float(np.float32(f32_band_epsilon(self.tables, l2p)))
        return e


def device_tables(tables: ScoringTables, device) -> DeviceTables:
    """Upload the weight-dependent tables to `device` (once per engine)."""
    import torch

    with spans.span("device_tables"):
        diff32 = np.concatenate([tables.diff_vals.astype(np.float32),
                                 [np.float32(0.0)]])
        return DeviceTables(
            tables=tables,
            code=torch.from_numpy(np.ascontiguousarray(tables.code)).to(device),
            w32=torch.from_numpy(tables.w_signed.astype(np.float32)).to(device),
            diff32=torch.from_numpy(diff32).to(device))


_DEVICE_TABLES_CACHE: dict = {}


def device_tables_cached(tables: ScoringTables, device) -> DeviceTables:
    """Memoized `device_tables` per (weights, mode, device): the sharded
    paths read each shard's tables on that shard's device, call after
    call."""
    key = (tuple(tables.weights.tolist()), tables.is_max, str(device))
    t = _DEVICE_TABLES_CACHE.get(key)
    if t is None:
        if len(_DEVICE_TABLES_CACHE) >= 64:
            _DEVICE_TABLES_CACHE.clear()
        t = _DEVICE_TABLES_CACHE[key] = device_tables(tables, device)
    return t
