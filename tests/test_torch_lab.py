"""The kernel lab's sweeps (psa_torch.ops._sweep_v2, _sweep_v3) and its
harness (psa_torch.utils.kernel_lab) against the JAX package's lab kernels
in interpret mode and the numpy oracle.  On the CPU the wrappers run their
plain PyTorch versions; every statistic is an exact integer, so the
tolerance is equality.  The JAX side runs at tile_o=512 to keep each call
near a second."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psa_tpu.core.alphabet import HYPHEN_CODE, OTHER_CODE, PAD_CODE
from psa_tpu.core.oracle import offset_stats_numpy
from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.ops import _sweep_v2 as jv2
from psa_tpu.ops import _sweep_v3 as jv3

from psa_torch.core.tables import build_tables
from psa_torch.ops import _sweep_v2 as v2
from psa_torch.ops import _sweep_v3 as v3
from psa_torch.ops import sweep as sw
from psa_torch.utils import kernel_lab

JAX_TILE = 512
WEIGHTS = [(1.0, 3.0, 4.0, 2.0), (2.0, 2.0, 2.0, 2.0), (-1.0, 2.0, -3.0, 4.0)]


def codes(rng, n, kind):
    """n codes of one kind: "clean" letters, letters with "hyphen"s,
    "lenient" (hyphens, OTHER_CODE and PAD_CODE inside the sequence) or
    "hyphens_only"."""
    if kind == "hyphens_only":
        return np.full(n, HYPHEN_CODE, np.int32)
    c = rng.integers(0, 26, n).astype(np.int32)
    if kind in ("hyphen", "lenient"):
        c[rng.random(n) < 0.08] = HYPHEN_CODE
    if kind == "lenient":
        c[rng.random(n) < 0.08] = OTHER_CODE
        c[rng.random(n) < 0.03] = PAD_CODE
    return c


def both_tables(weights, is_max):
    w = np.array(weights)
    return build_tables(w, is_max), jax_build_tables(w, is_max)


def assert_stats_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


V2_CASES = [("len1_eq_len2", 64, 64, "hyphen"), ("n2_one", 78, 1, "clean"),
            ("ragged", 700, 130, "hyphen"), ("lenient", 1500, 333, "lenient"),
            ("hyphens_only", 100, 30, "hyphens_only")]


@pytest.mark.parametrize("case", V2_CASES, ids=[c[0] for c in V2_CASES])
@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_offset_stats_v2_match_pallas_and_oracle(case, is_max, weights):
    """v2 counts class 3 from the nonzero pairs, so it is exact on every
    input, lenient ones included."""
    _, n1, n2, kind = case
    rng = np.random.default_rng(n1 * 31 + n2)
    c1, c2 = codes(rng, n1, kind), codes(rng, n2, kind)
    tables, jt = both_tables(weights, is_max)
    got = v2.offset_stats_v2(c1, c2, tables, "cpu")
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert_stats_equal(got, jv2.offset_stats_v2(c1, c2, jt, interpret=True,
                                                tile_o=JAX_TILE))
    assert_stats_equal(got, offset_stats_numpy(c1, c2, jt))


V3_CASES = [("len1_eq_len2", 64, 64, "clean"), ("n2_one", 78, 1, "hyphen"),
            ("ragged", 700, 130, "hyphen"), ("tiles", 3000, 300, "clean")]


@pytest.mark.parametrize("case", V3_CASES, ids=[c[0] for c in V3_CASES])
@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_offset_stats_v3_clean_match_pallas_and_oracle(case, is_max, weights):
    _, n1, n2, kind = case
    rng = np.random.default_rng(n1 * 17 + n2)
    c1, c2 = codes(rng, n1, kind), codes(rng, n2, kind)
    tables, jt = both_tables(weights, is_max)
    got = v3.offset_stats_v3(c1, c2, tables, "cpu")
    assert_stats_equal(got, jv3.offset_stats_v3(c1, c2, jt, interpret=True,
                                                tile_o=JAX_TILE))
    assert_stats_equal(got, offset_stats_numpy(c1, c2, jt))


@pytest.mark.parametrize("is_max", [False, True])
def test_offset_stats_v3_lenient_keeps_the_clean_input_contract(is_max):
    """On lenient inputs v3 rebuilds class 3 as n2 - the rest, as the JAX
    kernel does: port and JAX agree exactly, and both differ from the
    oracle in class 3 only."""
    rng = np.random.default_rng(5 + is_max)
    c1, c2 = codes(rng, 1500, "lenient"), codes(rng, 333, "lenient")
    tables, jt = both_tables(WEIGHTS[0], is_max)
    got = v3.offset_stats_v3(c1, c2, tables, "cpu")
    assert_stats_equal(got, jv3.offset_stats_v3(c1, c2, jt, interpret=True,
                                                tile_o=JAX_TILE))
    rc, rm = offset_stats_numpy(c1, c2, jt)
    np.testing.assert_array_equal(got[0][:, :3], rc[:, :3])
    np.testing.assert_array_equal(got[1], rm)
    assert (got[0][:, 3] > rc[:, 3]).all()
    np.testing.assert_array_equal(got[0].sum(1), np.full(len(rc), 333))


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_sweep_rows_match_pallas_interpret(variant):
    """All 8 rows of the port's sweep equal the JAX kernel's on the real
    offsets; v3's row 3 is zero in both."""
    rng = np.random.default_rng(11)
    n1, n2 = 1300, 270
    c1, c2 = codes(rng, n1, "hyphen"), codes(rng, n2, "hyphen")
    tables, jt = both_tables(WEIGHTS[0], False)
    if variant == "v2":
        _, noff_pad, l2p, l1k = jv2.plan_shapes_v2(n1, n2, JAX_TILE)
        a, b = jv2._prepare_v2(jnp.asarray(c1), jnp.asarray(c2),
                               jnp.asarray(jt.code), l1k, l2p)
        want = jv2._sweep_pallas_v2(a, b, noff_pad, l2p // jv2.CHUNK2, True,
                                    JAX_TILE)
        plan, fn = v2.plan_shapes_v2, v2.sweep_v2
    else:
        _, noff_pad, l2p, l1k = jv3.plan_shapes_v3(n1, n2, JAX_TILE)
        a, b = jv3._prepare_v3(jnp.asarray(c1), jnp.asarray(c2),
                               jnp.asarray(jt.code), l1k, l2p)
        want = jv3._sweep_pallas_v3(a, b, noff_pad, l2p // 256, True, JAX_TILE)
        plan, fn = v3.plan_shapes_v3, v3.sweep_v3
    noff, _, l2p, l1k = plan(n1, n2)
    got = fn(*sw.upload_codes("cpu", (c1, l1k), (c2, l2p)),
             torch.from_numpy(tables.code)).numpy()
    np.testing.assert_array_equal(got[:, :noff], np.asarray(want)[:, :noff])
    assert not got[5:].any()
    if variant == "v3":
        assert not got[3].any()


def test_sweep_v3_plain_is_sweep_plain_without_row_3():
    rng = np.random.default_rng(3)
    noff, noff_pad, l2p, l1k = v2.plan_shapes_v2(900, 200)
    d1, d2 = sw.upload_codes("cpu", (codes(rng, 900, "lenient"), l1k),
                             (codes(rng, 200, "lenient"), l2p))
    code = torch.from_numpy(build_tables(np.array(WEIGHTS[2]), True).code)
    want = sw.sweep_rows_plain(d1, d2, code, tile=v2.TILE, align=v2.CHUNK)
    assert torch.equal(v2.sweep_v2_plain(d1, d2, code), want)
    want[3] = 0
    assert torch.equal(v3.sweep_v3_plain(d1, d2, code), want)


@pytest.mark.parametrize("n2", [v3.MAX_N2, v3.MAX_N2 + 1])
def test_v3_refuses_what_jax_refuses(n2):
    """JAX's `_sweep_pallas_v3` asserts at most 127 chunks of 256 (checked
    here on its shape plan only: the interpreted run is too slow); the port
    raises ValueError past the same n2 and is exact up to it."""
    n1 = n2 + 99
    jax_takes = jv3.plan_shapes_v3(n1, n2)[2] // 256 <= 127
    assert jax_takes == (n2 <= 32_512)
    if not jax_takes:
        with pytest.raises(ValueError):
            v3.plan_shapes_v3(n1, n2)
        noff_pad, l2p = v3.TILE, v2.plan_shapes_v2(n1, n2)[2]
        with pytest.raises(ValueError):
            v3.sweep_v3(torch.zeros(noff_pad + l2p, dtype=torch.uint8),
                        torch.zeros(l2p, dtype=torch.uint8),
                        torch.zeros((32, 32), dtype=torch.int8))
        return
    rng = np.random.default_rng(8)
    c1, c2 = codes(rng, n1, "clean"), codes(rng, n2, "clean")
    tables, jt = both_tables(WEIGHTS[0], False)
    assert_stats_equal(v3.offset_stats_v3(c1, c2, tables, "cpu"),
                       offset_stats_numpy(c1, c2, jt))


@pytest.mark.parametrize("fn", [v2.sweep_v2, v3.sweep_v3, v2.sweep_v2_plain,
                                v3.sweep_v3_plain])
def test_lab_sweeps_reject_bad_operands(fn):
    code = torch.zeros((32, 32), dtype=torch.int8)
    c2 = torch.zeros(v2.CHUNK, dtype=torch.uint8)
    with pytest.raises(TypeError):
        fn(torch.zeros(v2.TILE + v2.CHUNK, dtype=torch.int32), c2, code)
    with pytest.raises(ValueError):                 # noff_pad not a tile
        fn(torch.zeros(v2.TILE + v2.CHUNK + 8, dtype=torch.uint8), c2, code)
    with pytest.raises(ValueError):                 # l2p not a whole chunk
        fn(torch.zeros(v2.TILE + 32, dtype=torch.uint8),
           torch.zeros(32, dtype=torch.uint8), code)


@pytest.mark.parametrize("fn", [v2.sweep_v2, v3.sweep_v3])
def test_lab_sweeps_raise_off_cpu_and_cuda(fn):
    """A tensor that is neither on the CPU nor on the card goes nowhere."""
    meta = dict(dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        fn(torch.empty(v2.TILE + v2.CHUNK, **meta),
           torch.empty(v2.CHUNK, **meta),
           torch.empty((32, 32), dtype=torch.int8, device="meta"))


def read_launches():
    return sw.launches, v2.launches_v2, v3.launches_v3


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_kernel_lab_cpu_check_passes(variant, capsys):
    """The lab on the CPU: the plain versions agree with the oracle, the
    last stdout line is the RESULT line, and no kernel is launched."""
    before = read_launches()
    rc = kernel_lab.main(["--variant", variant, "--device", "cpu", "--n1", "3000",
                          "--n2", "300", "--iters", "2", "--check"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "oracle check: OK" in err
    tile, chunk = {"v1": (sw.TILE_O, sw.L2_ALIGN), "v2": (v2.TILE, v2.CHUNK),
                   "v3": (v3.TILE, v3.CHUNK)}[variant]
    fields = out.strip().splitlines()[-1].split()
    assert fields[:4] == ["RESULT", variant, str(tile), str(chunk)]
    assert float(fields[4]) > 0
    assert read_launches() == before


def test_kernel_lab_check_fails_on_a_mismatch(monkeypatch, capsys):
    right = v2.offset_stats_v2

    def wrong(c1, c2, tables, device):
        counts, maxrank = right(c1, c2, tables, device)
        counts[0, 0] += 1
        return counts, maxrank

    monkeypatch.setattr(v2, "offset_stats_v2", wrong)
    rc = kernel_lab.main(["--variant", "v2", "--device", "cpu", "--n1", "700",
                          "--n2", "100", "--iters", "1", "--check"])
    out, err = capsys.readouterr()
    assert rc == 1 and "oracle check: FAIL" in err
    assert "RESULT" not in out


@pytest.mark.parametrize("argv", [["--variant", "v2"],
                                  ["--variant", "v3", "--device", "cpu",
                                   "--n1", "40000", "--n2", "32513"],
                                  ["--variant", "v1", "--device", "cpu",
                                   "--n1", "10", "--n2", "20"]])
def test_kernel_lab_refuses_without_result(argv, monkeypatch, capsys):
    """No card (the default device), a Seq2 past v3's limit, or n2 > n1:
    a non-zero exit and no RESULT line; never a fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_lab.main(argv) != 0
    assert "RESULT" not in capsys.readouterr().out


SASS = """
        Function : _ZN45_GLOBAL__N__71c8276e_12_sweep_mma_cu_c09359e616sweep_mma_kernelEPKhS1_iPKaPii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMMA.16832.S8.S8 R4, R8, R12, RZ ;
        /*0020*/                   STS.U8 [R2], R4 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/                   LDS R5, [R3] ;
        /*0050*/              @!P0 BRA 0x10 ;
        /*0060*/                   EXIT ;
        Function : _ZN40_GLOBAL__N__52b3b241_8_sweep_cu_4ac8ad9412sweep_kernelEPKhiS1_iPKaPii
        /*0000*/                   EXIT ;
"""


def test_sass_loop_mix_reads_the_main_loop():
    """The loop is the widest backward branch, split at its barriers; a
    kernel without a loop is left out."""
    mix = kernel_lab.sass_loop_mix(SASS)
    assert list(mix) == ["sweep_mma_kernel"]
    got = mix["sweep_mma_kernel"]
    assert got["instructions"] == 5 and got["segments"] == [2, 2]
    assert got["per_pair"] == 5 / v2.CHUNK
    assert got["mix"] == {"IMMA.16832.S8.S8": 1, "STS.U8": 1,
                          "BAR.SYNC.DEFER_BLOCKING": 1, "LDS": 1, "BRA": 1}


def test_sass_loop_mix_takes_the_batched_pair_loop():
    """The batched kernel's pair loop sits inside its persistent loop over
    work items, beside the mbarrier wait loop: the widest loop that holds
    no other is taken, and its pairs are kFlush x 32 (a run of kFlush
    positions against a lane's word of 32 offsets)."""
    ns = "_GLOBAL__N__71c8276e_16_sweep_batched_cu_c09359e6"
    name = f"_ZN{len(ns)}{ns}20sweep_batched_kernelILb0EEEvNS_4WorkEPKa"
    sass = f"""
        Function : {name}
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R9+URZ], R2 ;
        /*0020*/              @!P0 BRA 0x10 ;
        /*0030*/                   LDS R5, [R3] ;
        /*0040*/                   IADD3 R6, R6, R5, RZ ;
        /*0050*/                   VIMNMX.U32 R7, R7, R5, !PT ;
        /*0060*/               @P1 BRA 0x30 ;
        /*0070*/                   STG.E.128 [R8], R4 ;
        /*0080*/               @P2 BRA 0x10 ;
        /*0090*/                   EXIT ;
"""
    got = kernel_lab.sass_loop_mix(sass)["sweep_batched_kernel<false>"]
    assert got["instructions"] == 4 and got["segments"] == [4]
    assert got["per_pair"] == 4 / (sw.L2_ALIGN * 32)
    assert got["mix"] == {"LDS": 1, "IADD3": 1, "VIMNMX.U32": 1, "BRA": 1}
