"""The port's sweep (psa_torch.ops.sweep) against the JAX package's Pallas
sweep in interpret mode and its numpy oracle.  On the CPU the wrapper runs
the kernel's plain PyTorch version.  The port returns stats5 (rows 0-3 the
counts, row 4 the maxrank) where the TPU kernel returns 8 rows with the max
code in row 4, so row 4 is compared after `maxrank_from_maxcode`.  Every
statistic is an exact integer, so the tolerance is equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psa_tpu.core.alphabet import HYPHEN_CODE, OTHER_CODE, PAD_CODE
from psa_tpu.core.oracle import offset_stats_numpy
from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.ops import pallas_sweep as ps

from psa_torch.core.tables import build_tables
from psa_torch.ops import sweep as sw

from conftest import random_codes


def port_rows(c1, c2, tables, plain=False):
    """The port's (5, noff_pad) stats5 for codes c1, c2 on the CPU."""
    noff, noff_pad, l2p, l1k = sw.plan_shapes(c1.shape[0], c2.shape[0])
    d1, d2 = sw.upload_codes("cpu", (c1, l1k), (c2, l2p))
    code = torch.from_numpy(tables.code)
    fn = sw.sweep_plain if plain else sw.sweep
    got = fn(d1, d2, code).numpy()
    assert got.shape == (5, noff_pad) and got.dtype == np.int32
    return got, noff


def pallas_stats5(c1, c2, jt, tile=None):
    """psa_tpu's `_sweep_pallas` in interpret mode at its own padding,
    followed by `maxrank_from_maxcode`: (5, noff_pad) int32."""
    n1, n2 = c1.shape[0], c2.shape[0]
    if tile is None:
        _, noff_pad, l2p, l1k = ps.plan_shapes(n1, n2)
    else:
        l2p = 512
        noff_pad = ps.round_up(n1 - n2 + 1, tile)
        l1k = noff_pad + l2p
    s1oh, pc = ps._prepare(jnp.asarray(c1), jnp.asarray(c2),
                           jnp.asarray(jt.code), l1k, l2p)
    out = np.asarray(ps._sweep_pallas(s1oh, pc, noff_pad, l2p // ps.CHUNK,
                                      True, tile))
    return np.concatenate([out[:4], ps.maxrank_from_maxcode(out[4:5])])


@pytest.mark.parametrize("n1,n2,tile", [(300, 40, None), (845, 400, None),
                                        (513, 512, None), (3000, 500, 512)])
def test_sweep_rows_match_pallas_interpret(n1, n2, tile):
    rng = np.random.default_rng(n1 * 7 + n2)
    jt = jax_build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    c1 = random_codes(rng, n1)
    c2 = random_codes(rng, n2)
    want = pallas_stats5(c1, c2, jt, tile)
    got, noff = port_rows(c1, c2, build_tables(np.array([1.0, 3.0, 4.0, 2.0]),
                                               False))
    np.testing.assert_array_equal(got[:, :noff], want[:, :noff])


@pytest.mark.parametrize("noff", [1, 255, 256, 257, 1023, 1025])
@pytest.mark.parametrize("is_max", [False, True])
def test_stats5_matches_pallas_at_tile_padding(noff, is_max):
    """The port pads offsets to 256-offset warp tiles: real offset counts
    below, at and above a tile and 1024, with hyphens and OTHER_CODE in
    both sequences, against `_sweep_pallas` + `maxrank_from_maxcode`."""
    rng = np.random.default_rng(noff * 2 + is_max)
    w = np.array([2.0, 1.0, 5.0, 0.5])
    n2 = 70
    c1 = random_codes(rng, noff + n2 - 1, 0.05)
    c2 = random_codes(rng, n2, 0.05)
    c1[::13] = OTHER_CODE
    c2[::11] = OTHER_CODE
    c1[5::17] = HYPHEN_CODE
    c2[3::19] = HYPHEN_CODE
    got, got_noff = port_rows(c1, c2, build_tables(w, is_max))
    assert got_noff == noff and got.shape[1] == sw.round_up(noff, 256)
    np.testing.assert_array_equal(
        got[:, :noff], pallas_stats5(c1, c2, jax_build_tables(w, is_max))[:, :noff])


DEGENERATE = [
    (np.zeros(64, np.int32), np.zeros(64, np.int32)),            # len1 == len2
    (np.arange(26, dtype=np.int32).repeat(3), np.array([0], np.int32)),
    (np.full(100, 26, np.int32), np.full(30, 26, np.int32)),     # all hyphens
]


@pytest.mark.parametrize("case", range(len(DEGENERATE)))
def test_offset_stats_degenerate_match_pallas(case):
    c1, c2 = DEGENERATE[case]
    w = np.array([1.0, 3.0, 4.0, 2.0])
    want = ps.offset_stats_pallas(c1, c2, jax_build_tables(w, False),
                                  interpret=True)
    got = sw.offset_stats(c1, c2, build_tables(w, False), "cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("is_max", [True, False])
def test_offset_stats_other_code_match_pallas(is_max):
    """Lenient inputs: OTHER_CODE weighs 0 and never substitutes, so class 3
    must be the real count, not n2 minus the rest."""
    rng = np.random.default_rng(77 + is_max)
    w = np.array([1.0, 3.0, 4.0, 2.0])
    c1 = random_codes(rng, 500)
    c2 = random_codes(rng, 120)
    c1[::7] = OTHER_CODE
    c2[::11] = OTHER_CODE
    want = ps.offset_stats_pallas(c1, c2, jax_build_tables(w, is_max),
                                  interpret=True)
    got = sw.offset_stats(c1, c2, build_tables(w, is_max), "cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("weights", [(1.0, 3.0, 4.0, 2.0), (2.0, 2.0, 2.0, 2.0),
                                     (-1.0, 2.0, -3.0, 4.0)])
@pytest.mark.parametrize("is_max", [True, False])
def test_offset_stats_match_numpy_oracle(weights, is_max):
    """Random codes over the whole alphabet, PAD_CODE included, at shapes
    that span several offset tiles and a ragged Seq2."""
    rng = np.random.default_rng(hash((weights, is_max)) % 2**32)
    tables = build_tables(np.array(weights), is_max)
    c1 = rng.integers(0, PAD_CODE + 1, 2500).astype(np.int32)
    c2 = rng.integers(0, PAD_CODE + 1, 333).astype(np.int32)
    counts, maxrank = sw.offset_stats(c1, c2, tables, "cpu")
    rc, rm = offset_stats_numpy(c1, c2, jax_build_tables(np.array(weights),
                                                          is_max))
    np.testing.assert_array_equal(counts, rc)
    np.testing.assert_array_equal(maxrank, rm)


def test_plain_blocking_does_not_change_rows():
    """A block size that cuts the offsets mid-tile gives the same stats."""
    rng = np.random.default_rng(5)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), True)
    c1 = random_codes(rng, 1500)
    c2 = random_codes(rng, 200)
    noff, noff_pad, l2p, l1k = sw.plan_shapes(1500, 200)
    d1, d2 = sw.upload_codes("cpu", (c1, l1k), (c2, l2p))
    code = torch.from_numpy(tables.code)
    np.testing.assert_array_equal(sw.sweep_plain(d1, d2, code).numpy(),
                                  sw.sweep_plain(d1, d2, code, 7 * l2p).numpy())


def test_sweep_rejects_bad_operands():
    code = torch.zeros((32, 32), dtype=torch.int8)
    c2 = torch.zeros(32, dtype=torch.uint8)
    with pytest.raises(TypeError):
        sw.sweep(torch.zeros(1024 + 32, dtype=torch.int32), c2, code)
    with pytest.raises(ValueError):                 # noff_pad not a tile
        sw.sweep(torch.zeros(1000, dtype=torch.uint8), c2, code)
    with pytest.raises(ValueError):                 # 512 + 128: half a tile
        sw.sweep(torch.zeros(512 + 128 + 32, dtype=torch.uint8), c2, code)
    with pytest.raises(ValueError):                 # l2p not aligned
        sw.sweep(torch.zeros(1024 + 33, dtype=torch.uint8),
                 torch.zeros(33, dtype=torch.uint8), code)

