"""The port's native host library (psa_torch.native) against the JAX
package's (psa_tpu.native) and against the port's numpy functions, bit for
bit: the same C++ source built into another file, over seeded queries in
both modes, with weights that include 0, negatives, 0.5 and 1e6.  Then the
places that choose between native and numpy (host selection, the encode of
the batch path), and what happens when the library cannot be built."""

import os

import numpy as np
import pytest

from psa_tpu import native as jnative
from psa_tpu.core.alphabet import encode_batch_padded as jax_encode_batch_padded
from psa_tpu.core.tables import build_tables as jax_build_tables

from psa_torch import native
from psa_torch.core import alphabet
from psa_torch.core.oracle import (offset_stats_numpy, rescore_candidates,
                                   rescore_multi, score_offset_sequential)
from psa_torch.core.result import NoMutationFound
from psa_torch.core.tables import build_tables
from psa_torch.models import batch
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.ops import select

from conftest import random_codes, random_seq

WEIGHTS = [(1.0, 3.0, 4.0, 2.0), (0.0, 0.0, 0.0, 0.0), (-1.0, 2.0, -3.0, 4.0),
           (0.5, 0.5, 1e6, -0.5), (1e6, 0.0, 0.5, -1e6)]
CASES = [(w, is_max) for w in WEIGHTS for is_max in (False, True)]


def winner(res):
    return (res.offset, res.char_offset, res.sub_code, res.score)


def codes_with_other(rng, n):
    """Codes over A-Z with hyphens and a few out-of-alphabet characters."""
    c = random_codes(rng, n, 0.05)
    c[rng.random(n) < 0.03] = alphabet.OTHER_CODE
    return c


@pytest.fixture(autouse=True)
def _library():
    assert native.available(), "g++ builds the library here"


@pytest.mark.parametrize("weights,is_max", CASES)
def test_search_native_matches_jax_native_and_numpy(weights, is_max):
    rng = np.random.default_rng(abs(hash((weights, is_max))) % 2**32)
    t, jt = build_tables(np.array(weights), is_max), jax_build_tables(np.array(weights), is_max)
    numpy_eng = AlignmentSearchEngine(weights, is_max, backend="numpy")
    for n1, n2 in [(900, 150), (301, 300), (1200, 37)]:
        c1, c2 = codes_with_other(rng, n1), codes_with_other(rng, n2)
        noff = n1 - n2 + 1
        want = winner(numpy_eng.search_codes(c1, c2))
        for nthreads in (0, 1):
            assert winner(native.search_native(c1, c2, t, nthreads)) == want
        assert winner(jnative.search_native(c1, c2, jt)) == want
        # an offset range: the same as psa_tpu's, and the numpy engine on
        # the window of those offsets (offsets shifted by `lo`)
        lo, hi = noff // 3, noff - noff // 5
        for nthreads in (0, 1):
            got = native.search_native(c1, c2, t, nthreads, lo, hi)
            assert winner(got) == winner(jnative.search_native(
                c1, c2, jt, nthreads, lo, hi))
            sub = numpy_eng.search_codes(c1[lo: hi + n2 - 1], c2)
            assert winner(got) == (sub.offset + lo, *winner(sub)[1:])


def test_search_native_empty_range_and_no_mutation():
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), True)
    c1 = np.full(200, alphabet.OTHER_CODE, np.int32)
    c2 = np.full(40, alphabet.OTHER_CODE, np.int32)
    with pytest.raises(NoMutationFound):
        native.search_native(c1, c2, t)
    rng = np.random.default_rng(3)
    c1, c2 = random_codes(rng, 200), random_codes(rng, 40)
    with pytest.raises(NoMutationFound):
        native.search_native(c1, c2, t, first_offset=50, last_offset=50)
    with pytest.raises(ValueError):
        native.search_native(c1, c2, t, first_offset=0, last_offset=500)


@pytest.mark.parametrize("weights,is_max", CASES)
def test_rescore_multi_native_matches_numpy(weights, is_max):
    rng = np.random.default_rng(21 + 2 * WEIGHTS.index(weights) + is_max)
    t, jt = build_tables(np.array(weights), is_max), jax_build_tables(np.array(weights), is_max)
    b, l1, l2 = 9, 500, 128
    c1b = rng.integers(0, 29, (b, l1)).astype(np.uint8)
    c2b = rng.integers(0, 28, (b, l2)).astype(np.uint8)
    n2s = rng.integers(1, l2 + 1, b).astype(np.int32)
    n2s[2] = l2
    qidx = np.sort(rng.integers(0, b, 300)).astype(np.int32)
    offs = np.array([rng.integers(0, l1 - n2s[q] + 1) for q in qidx], np.int64)
    got = native.rescore_multi_native(c1b, c2b, n2s, t, qidx, offs)
    want = rescore_multi(c1b, c2b, n2s, t, qidx, offs)
    jwant = jnative.rescore_multi_native(c1b.astype(np.int32), c2b.astype(np.int32),
                                         n2s, jt, qidx, offs)
    for g, w, j in zip(got, want, jwant):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
    # one query's candidates: the numpy single-query re-scorer, and the
    # library's one-offset scan for the first three
    q = int(qidx[0])
    mine = qidx == q
    c1, c2 = c1b[q].astype(np.int32), c2b[q, : n2s[q]].astype(np.int32)
    for g, w in zip(got, rescore_candidates(c1, c2, t, offs[mine])):
        np.testing.assert_array_equal(g[mine], w)
    for o in offs[mine][:3]:
        total, ci, si, _ = native.score_offset_native(c1, c2, t, int(o))
        assert (total, ci, si) == score_offset_sequential(c1, c2, t, int(o))[:3]
    with pytest.raises(ValueError):
        native.rescore_multi_native(c1b, c2b, n2s, t, qidx[:1],
                                    np.array([l1], np.int64))


def numpy_encode(monkeypatch, seqs, length):
    """encode_batch_checked's numpy branch."""
    with monkeypatch.context() as m:
        m.setattr(native, "_available", False)
        return alphabet.encode_batch_checked(seqs, length)


@pytest.mark.parametrize("lenient", [False, True])
def test_encode_padded_native_matches_numpy(monkeypatch, lenient):
    rng = np.random.default_rng(5 + lenient)
    seqs = [random_seq(rng, int(n)) for n in rng.integers(0, 300, 40)]
    if lenient:
        seqs = [s[:5] + "?a*z#1" + s[5:] + "é-" for s in seqs] + ["", "ÿ" * 7]
    length = max(len(s) for s in seqs) + 9
    before = native.calls["encode_checked"]
    got, ok = alphabet.encode_batch_checked(seqs, length)
    assert native.calls["encode_checked"] == before + 1
    want, want_ok = numpy_encode(monkeypatch, seqs, length)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (len(seqs), length)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, want_ok)
    assert bool(ok.all()) is not lenient
    np.testing.assert_array_equal(got.view(np.int8),
                                  jax_encode_batch_padded(seqs, length))
    with pytest.raises(ValueError):
        alphabet.encode_batch_checked(seqs, length - 10)


@pytest.mark.parametrize("weights,is_max", CASES[:6])
def test_offset_stats_native_matches_numpy(weights, is_max):
    rng = np.random.default_rng(31 + 2 * WEIGHTS.index(weights) + is_max)
    t, jt = build_tables(np.array(weights), is_max), jax_build_tables(np.array(weights), is_max)
    c1, c2 = codes_with_other(rng, 2500), codes_with_other(rng, 190)
    got = native.offset_stats_native(c1, c2, t)
    for want in (offset_stats_numpy(c1, c2, t), jnative.offset_stats_native(c1, c2, jt)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    eng = AlignmentSearchEngine(weights, is_max, backend="native")
    for g, w in zip(eng.offset_stats(c1, c2), got):
        np.testing.assert_array_equal(g, w)


def test_library_is_built_from_the_port_source_into_build_dir():
    path = native.lib_path()
    root = os.path.dirname(os.path.dirname(native.__file__))
    assert os.path.dirname(path) == os.path.join(root, "_build")
    assert os.path.isfile(path)
    assert os.path.basename(path).startswith("libpsa_host-")
    assert native.host_engine() == "native"
    assert native.omp_max_threads() >= 1


@pytest.mark.parametrize("is_max", [False, True])
def test_host_selection_runs_native(is_max):
    """The device path's selection on the CPU goes through the library's
    re-scorer, and picks what the numpy engine picks."""
    rng = np.random.default_rng(50 + is_max)
    c1, c2 = random_codes(rng, 3000), random_codes(rng, 400)
    before = native.calls["rescore_multi"]
    got = AlignmentSearchEngine((1, 3, 4, 2), is_max, device="cpu").search_codes(c1, c2)
    assert native.calls["rescore_multi"] == before + 1
    want = AlignmentSearchEngine((1, 3, 4, 2), is_max, backend="numpy").search_codes(c1, c2)
    assert winner(got) == winner(want)


@pytest.fixture
def broken_build(monkeypatch, tmp_path):
    """A library that cannot be built: no file at its path, and g++ fails."""
    def fail(path):
        raise RuntimeError("g++ failed (test)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_available", None)
    monkeypatch.setattr(native, "lib_path", lambda: str(tmp_path / "libpsa_host.so"))
    monkeypatch.setattr(native, "_build", fail)


def test_failed_build_reports_numpy_and_keeps_the_winner(broken_build, tmp_path):
    assert not native.available()
    assert native.host_engine() == "numpy"
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        AlignmentSearchEngine((1, 3, 4, 2), False, backend="native")
    with pytest.raises(RuntimeError):
        batch.search_batch([], backend="native")
    from psa_torch.utils import cli

    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2 ABCDEFGH CDE minimum\n")
    assert cli.main([str(inp), "--backend", "native", "--quiet",
                     "-o", str(tmp_path / "o.txt")]) == 2
    rng = np.random.default_rng(8)
    c1, c2 = random_codes(rng, 2000), random_codes(rng, 300)
    before = dict(native.calls)
    got = AlignmentSearchEngine((1, 3, 4, 2), False, device="cpu").search_codes(c1, c2)
    # the hybrid's host block needs the library; all-device does not
    with pytest.raises(RuntimeError, match="native"):
        AlignmentSearchEngine((1, 3, 4, 2), False, backend="hybrid", device="cpu",
                              device_share=50).search_codes(c1, c2)
    dev_only = AlignmentSearchEngine((1, 3, 4, 2), False, backend="hybrid", device="cpu",
                                     device_share=100).search_codes(c1, c2)
    auto = AlignmentSearchEngine((1, 3, 4, 2), False, backend="auto",
                                 device="cpu").search_codes(c1, c2)
    assert dict(native.calls) == before
    want = jnative.search_native(c1, c2, jax_build_tables(np.array([1.0, 3, 4, 2]), False))
    assert winner(got) == winner(dev_only) == winner(auto) == winner(want)
    assert select.native.available() is False
