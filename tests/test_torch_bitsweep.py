"""A numpy model of the bit-sliced pair loop of csrc/sweep_core.cuh, held
integer for integer against `ops/sweep.sweep_plain` and the batched plain
versions.

The model follows the kernel's arithmetic step by step, vectorised over
the 32 lanes of a warp tile (lane L owns offsets 32 L .. 32 L + 31 of the
tile, one 32-bit word) and over the tiles of a row:

* masks from the fused table, once: per Seq1 code a, a 32-bit row over
  the Seq2 codes b for each kind (v > 0; class bit 0; class bit 1; rank at
  least a threshold, the table's top rank first);
* the window's bit vectors: column c, kind k, code b holds bit j when the
  window's Seq1 code 32 c + j is in mask k of b, made by the warp's
  five-round shuffle transpose of the lanes' mask rows;
* per position i = 32 q + r of a step, lane L's word of kind k is the
  funnel shift by r of columns q + L and q + L + 1 of code s2[i];
* carry-save adders (Harley-Seal over a chunk of 32 positions, the carry
  of 32 rippled into six higher planes) count each kind bit-sliced;
* at the end of a step, bit-sliced subtraction turns the counts of (v > 0,
  bit 0, bit 1, both bits) into the four class counts, the rank threshold
  passes run top-down while any offset of the tile has not met one, and a
  32 x 32 bit transpose a lane turns two rows' planes into each offset's
  ints (a half-word each);
* steps of a tile carry their last 32 columns over to the next step;
* offsets pad to 256 (TILE_O), so a row's last tile may reach past
  noff_pad: its window beyond the row holds whatever the staging buffer
  held (random bytes here), and only lanes inside noff_pad vote or write.
"""

import numpy as np
import pytest
import torch

from psa_torch.core.alphabet import HYPHEN_CODE, OTHER_CODE, PAD_CODE
from psa_torch.core.tables import build_tables
from psa_torch.ops import sweep as sw

from conftest import random_codes

M32 = np.uint64(0xFFFFFFFF)
LANES = np.arange(32)
LO_MASK = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
           1: 0x55555555}
TILE = 1024          # offsets per warp tile (kGranule)
SEG = 1024           # positions per step (kSegB)


def u32(x):
    return np.asarray(x, dtype=np.uint64) & M32


def rotr(y, s):
    """Rotate right by s (per lane), as `__funnelshift_r(y, y, s)`."""
    y, s = u32(y), np.asarray(s, np.uint64) & np.uint64(31)
    return u32((y >> s) | (y << ((np.uint64(32) - s) & np.uint64(31))))


def warp_transpose(x):
    """The kernel's `warp_transpose`: 32 lanes' words (..., 32) in, lane b's
    bit j = lane j's bit b out; five rounds of shuffle, rotate and merge."""
    x = u32(x)
    for m in (16, 8, 4, 2, 1):
        y = x[..., LANES ^ m]
        up = (LANES & m) != 0
        lo = np.uint64(LO_MASK[m])
        keep = np.where(up, u32(~lo), lo)
        r = rotr(y, np.where(up, m, 32 - m))
        x = (x & keep) | (r & u32(~keep))
    return x


def unslice(planes):
    """The kernel's `unslice`: bit planes (n, ...) of 32 offsets each in,
    (32, ...) ints out, offset j's value = sum of bit j of plane i << i."""
    v = [u32(p) for p in planes]
    v += [np.zeros_like(v[0])] * (32 - len(v))
    for w in (16, 8, 4, 2, 1):
        m = np.uint64(LO_MASK[w])
        for i in range(32):
            if i & w:
                continue
            t = ((v[i] >> np.uint64(w)) ^ v[i + w]) & m
            v[i + w] = v[i + w] ^ t
            v[i] = u32(v[i] ^ (t << np.uint64(w)))
    return np.stack(v).astype(np.int64)


def unslice2(a, b):
    """The kernel's `unslice2`: two rows' planes (at most 16 each) in one
    transpose, a's in matrix rows 0-15 and b's in 16-31; (a's ints, b's
    ints) out, the low and the high half of each word."""
    zero = np.zeros_like(u32(a[0]))
    v = unslice(list(a) + [zero] * (16 - len(a)) + list(b))
    return v & 0xFFFF, v >> 16


def csa(acc, a, b):
    """One carry-save adder: (carry, sum) of three words."""
    return (acc & a) | (acc & b) | (a & b), acc ^ a ^ b


def ripple(planes, c):
    """Add the one-bit word c into bit-sliced planes, lowest first."""
    for n in range(len(planes)):
        planes[n], c = planes[n] ^ c, planes[n] & c
    assert not np.any(c), "bit-sliced counter overflow"


def subtract(x, y):
    """Bit-sliced x - y (both lists of planes; no borrow out)."""
    out, br = [], np.zeros_like(x[0])
    for xn, yn in zip(x, y):
        out.append(xn ^ yn ^ br)
        br = (u32(~xn) & yn) | (u32(~(xn ^ yn)) & br)
    assert not np.any(br), "negative count"
    return out


def table_masks(code):
    """(rows (4, 32) uint64: lane a's mask rows over b for v > 0, class bit
    0, class bit 1 and the top rank; top rank R; thr(r) rows)."""
    v = np.asarray(code, np.int64) & 0xFF
    bits = np.uint64(1) << np.arange(32, dtype=np.uint64)

    def rows(pred):
        return (pred.astype(np.uint64) * bits[None, :]).sum(1).astype(np.uint64)

    ranks = np.where(v > 0, ((v - 1) >> 2) - 1, -2)
    top = int(ranks.max()) if (v > 0).any() else -1
    top = max(top, -1)

    def thr(r):
        return rows(v >= 4 * r + 5)

    valid = rows(v > 0)
    b0 = rows((v > 0) & (((v - 1) & 1) != 0))
    b1 = rows((v > 0) & (((v - 1) & 2) != 0))
    t = thr(top) if top >= 0 else np.zeros(32, np.uint64)
    return np.stack([valid, b0, b1, t]), top, thr


def build_columns(rows_k, win, cols):
    """Bit vectors (tiles, 32 codes, cols) of one kind from the staged
    window codes (tiles, >= 32 cols): the warp transpose of the lanes' mask
    rows, one column at a time."""
    a = win[:, :32 * cols].reshape(win.shape[0], cols, 32) & 31
    return np.swapaxes(warp_transpose(rows_k[a]), 1, 2)


def lane_words(vec, b, q, r):
    """Lane L's word (tiles, 32) at position 32 q + r of code b (tiles,):
    the funnel shift by r of columns q + L and q + L + 1."""
    t = np.arange(vec.shape[0])[:, None]
    lo = vec[t, b[:, None], q + LANES[None, :]]
    if r == 0:
        return lo
    hi = vec[t, b[:, None], q + 1 + LANES[None, :]]
    return u32((lo >> np.uint64(r)) | (hi << np.uint64(32 - r)))


def tree(acc, pos, level, r0):
    """Harley-Seal over 2**level positions from r0: counts into acc[k][0 ..
    level - 1], returns each kind's carry of weight 2**level."""
    if level == 1:
        a, b = pos(r0), pos(r0 + 1)
    else:
        a = tree(acc, pos, level - 1, r0)
        b = tree(acc, pos, level - 1, r0 + (1 << (level - 1)))
    out = []
    for k in range(4):
        c, acc[k][level - 1] = csa(acc[k][level - 1], a[k], b[k])
        out.append(c)
    return out


def model_rows(c1, c2, code, counters=None):
    """stats5 (5, noff_pad) of one row as the bit-sliced kernel computes it:
    each tile swept by one worker in steps of SEG positions."""
    c2 = np.asarray(c2, np.int64) & 31
    l2p = c2.shape[0]
    noff_pad = c1.shape[0] - l2p
    assert noff_pad % sw.TILE_O == 0 and l2p % 32 == 0
    tiles = -(-noff_pad // TILE)
    stale = np.random.default_rng(noff_pad).integers(0, 256, tiles * TILE - noff_pad)
    c1 = np.concatenate([np.asarray(c1, np.int64), stale])
    lanes = np.minimum(32, (noff_pad - TILE * np.arange(tiles)) // 32)
    valid = LANES[None, :] < lanes[:, None]
    rows, top, thr = table_masks(code)
    out = np.zeros((5, tiles * TILE), np.int64)
    vec = None
    passes = np.zeros(tiles, np.int64)
    steps = 0
    for p0 in range(0, l2p, SEG):
        seg = min(SEG, l2p - p0)
        cols = (TILE + seg) // 32
        win = np.stack([c1[t * TILE + p0: t * TILE + p0 + TILE + seg]
                        for t in range(tiles)])
        carry = vec is not None and seg_prev == SEG and not dirty
        if carry:
            vec = [np.concatenate([v[:, :, 32:64], build_columns(
                rows[k], win[:, 32 * 32:], cols - 32)], axis=2)
                for k, v in enumerate(vec)]
        else:
            vec = [build_columns(rows[k], win, cols) for k in range(4)]
        acc = [[np.zeros((tiles, 32), np.uint64) for _ in range(5)]
               for _ in range(4)]
        hi = [[np.zeros((tiles, 32), np.uint64) for _ in range(6)]
              for _ in range(4)]
        topw = np.zeros((tiles, 32), np.uint64)
        for q in range(seg // 32):
            b = c2[p0 + 32 * q: p0 + 32 * q + 32]

            def pos(r):
                nonlocal topw
                bb = np.full(tiles, b[r])
                x = [lane_words(vec[k], bb, q, r) for k in range(4)]
                topw = topw | x[3]
                return [x[0], x[1], x[2], x[1] & x[2]]

            c32 = tree(acc, pos, 5, 0)
            for k in range(4):
                ripple(hi[k], c32[k])
        n = [acc[k] + hi[k] for k in range(4)]      # 11 planes a kind
        c3 = n[3]
        c1p = subtract(n[1], c3)
        c2p = subtract(n[2], c3)
        c0p = subtract(subtract(n[0], n[1]), c2p)
        if p0 == 0:
            got_tile = np.zeros((tiles, 32), np.uint64)
        got = topw | got_tile       # the top rank met in this step or before
        rp = [topw if (top + 1) >> i & 1 else np.zeros_like(topw)
              for i in range(5)]
        passes += 1
        dirty = False
        for r0 in range(top - 1, -1, -4):
            # the vote is the warp's: a tile passes while any lane is open
            open_ = np.any(valid & (got != M32), axis=1)
            if not open_.any():
                break
            rs = [r0 - k for k in range(4)]
            vr = [build_columns(thr(r) if r >= 0 else np.zeros(32, np.uint64),
                                win, cols) for r in rs]
            met = [np.zeros((tiles, 32), np.uint64) for _ in range(4)]
            for q in range(seg // 32):
                for r2 in range(32):
                    bb = np.full(tiles, c2[p0 + 32 * q + r2])
                    for k in range(4):
                        met[k] |= lane_words(vr[k], bb, q, r2)
            for k, r in enumerate(rs):
                if r < 0:
                    continue
                w = np.where(open_[:, None], met[k], 0).astype(np.uint64)
                new = w & u32(~got)
                for i in range(5):
                    if (r + 1) >> i & 1:
                        rp[i] = rp[i] | new
                got = got | new
            passes += open_
            dirty = True
        got_tile = got_tile | topw
        steps += 1
        seg_prev = seg
        r0, r1 = unslice2(c0p, c1p)
        r2, r3 = unslice2(c2p, c3)
        rank = unslice2(rp, [np.zeros_like(rp[0])])[0] - 1
        step = np.stack([r0, r1, r2, r3])
        # (kind, 32 offsets j, tiles, lanes) -> offsets t * TILE + 32 L + j
        step = np.transpose(step, (0, 2, 3, 1)).reshape(4, tiles * TILE)
        rank = np.transpose(rank, (1, 2, 0)).reshape(tiles * TILE)
        if p0 == 0:
            out[:4], out[4] = step, rank
        else:
            out[:4] += step
            out[4] = np.maximum(out[4], rank)
    if counters is not None:
        counters[0] += int(passes.sum())
        counters[1] += steps * tiles
    return out[:, :noff_pad].astype(np.int32)


# --- the pieces, against numpy ----------------------------------------------

def test_warp_transpose_is_a_transpose():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, size=(3, 32), dtype=np.uint64)
    bits = (x[:, :, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    want = (np.swapaxes(bits, 1, 2) << np.arange(32, dtype=np.uint64)).sum(2)
    np.testing.assert_array_equal(warp_transpose(x), want)


def test_unslice_sums_the_planes():
    rng = np.random.default_rng(2)
    planes = rng.integers(0, 2**32, size=(11, 4), dtype=np.uint64)
    j = np.arange(32, dtype=np.uint64)[:, None]
    want = sum(((planes[i][None, :] >> j) & np.uint64(1)).astype(np.int64) << i
               for i in range(11))
    np.testing.assert_array_equal(unslice(list(planes)), want)


def test_harley_seal_counts_a_chunk_exactly():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=(64, 5), dtype=np.uint64)
    acc = [[np.zeros(5, np.uint64) for _ in range(5)] for _ in range(4)]
    hi = [[np.zeros(5, np.uint64) for _ in range(6)] for _ in range(4)]
    for q in range(2):
        c = tree(acc, lambda r: [words[32 * q + r]] * 4, 5, 0)
        ripple(hi[0], c[0])
    got = unslice(acc[0] + hi[0])
    j = np.arange(32, dtype=np.uint64)[:, None, None]
    want = ((words[None] >> j) & np.uint64(1)).sum(1).astype(np.int64)
    np.testing.assert_array_equal(got, want)


# --- the model, against the plain versions ----------------------------------

WEIGHTS = [((1.0, 3.0, 4.0, 2.0), False), ((1.0, 3.0, 4.0, 2.0), True),
           ((2.0, 1.0, 1.0, 1.0), False), ((2.0, 1.0, 1.0, 1.0), True),
           ((-2.0, 1e6, 1e-7, 0.0), False), ((-2.0, 1e6, 1e-7, 0.0), True)]


def lenient_codes(rng, n):
    """Random letters with hyphens, OTHER_CODE and PAD_CODE at both ends,
    as lenient input and padding give them."""
    c = random_codes(rng, n, 0.05)
    c[rng.random(n) < 0.03] = OTHER_CODE
    c[: min(3, n)] = PAD_CODE
    c[-min(2, n):] = PAD_CODE
    return c


def padded(c1, c2):
    """(c1 (noff_pad + l2p,), c2 (l2p,)) uint8 at the port's padding."""
    _, noff_pad, l2p, l1k = sw.plan_shapes(c1.shape[0], c2.shape[0])
    a = np.full(l1k, PAD_CODE, np.uint8)
    a[: c1.shape[0]] = c1
    b = np.full(l2p, PAD_CODE, np.uint8)
    b[: c2.shape[0]] = c2
    return a, b


@pytest.mark.parametrize("n2", [32, 992, 1024, 1056, 4128])
@pytest.mark.parametrize("weights,is_max", WEIGHTS[:3])
def test_model_matches_sweep_plain(n2, weights, is_max):
    rng = np.random.default_rng(n2 + 7 * is_max + int(weights[0]))
    tables = build_tables(np.array(weights), is_max)
    c1, c2 = padded(lenient_codes(rng, n2 + 1500), lenient_codes(rng, n2))
    want = sw.sweep_plain(torch.from_numpy(c1), torch.from_numpy(c2),
                          torch.from_numpy(tables.code)).numpy()
    np.testing.assert_array_equal(model_rows(c1, c2, tables.code), want)


@pytest.mark.parametrize("weights,is_max", WEIGHTS)
@pytest.mark.parametrize("letters", ["random", "all_A"])
def test_model_rank_passes(weights, is_max, letters):
    """All-'A' rows miss the top rank at every offset and take the lower
    threshold passes; random rows take one pass a step."""
    rng = np.random.default_rng(11 + is_max)
    tables = build_tables(np.array(weights), is_max)
    if letters == "all_A":
        a, b = np.zeros(2600, np.int32), np.zeros(1056, np.int32)
    else:
        a, b = random_codes(rng, 2600, 0.0), random_codes(rng, 1056, 0.0)
    c1, c2 = padded(a, b)
    counters = [0, 0]
    got = model_rows(c1, c2, tables.code, counters)
    want = sw.sweep_plain(torch.from_numpy(c1), torch.from_numpy(c2),
                          torch.from_numpy(tables.code)).numpy()
    np.testing.assert_array_equal(got, want)
    assert counters[1] == 2 * 2          # 2 tiles x 2 steps
    if letters == "all_A" and want[4, 0] < table_masks(tables.code)[1]:
        assert counters[0] > counters[1]


@pytest.mark.parametrize("shared", [False, True])
def test_model_matches_batched_plain(shared):
    rng = np.random.default_rng(5 + shared)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    code = torch.from_numpy(tables.code)
    n2 = 1056
    noff_pad, l1k = sw.plan_bucket([900, 1400, 1700], sw.round_up(n2, 32))
    l2p = l1k - noff_pad
    c2b = np.full((3, l2p), PAD_CODE, np.uint8)
    c1b = np.full((3, l1k), PAD_CODE, np.uint8)
    for q, noff in enumerate((900, 1400, 1700)):
        c2b[q, :n2] = lenient_codes(rng, n2)
        c1b[q, :noff + n2 - 1] = lenient_codes(rng, noff + n2 - 1)
    if shared:
        want = sw.sweep_batched_shared_plain(torch.from_numpy(c1b[2]),
                                             torch.from_numpy(c2b), code)
        got = np.stack([model_rows(c1b[2], c2b[q], tables.code)
                        for q in range(3)])
    else:
        want = sw.sweep_batched_plain(torch.from_numpy(c1b),
                                      torch.from_numpy(c2b), code)
        got = np.stack([model_rows(c1b[q], c2b[q], tables.code)
                        for q in range(3)])
    np.testing.assert_array_equal(got, want.numpy())
