"""The checked encode (`psa_torch.core.alphabet.encode_checked`,
`encode_batch_checked`): one pass from each string to the kernels' uint8
codes with the alphabet check read from it, through the native library and
through its fallback, against the JAX package's `encode` and `validate`;
and the batch front's strict-mode contract on top of it: the lowest bad
case index, named before any bucket runs, and lenient mode's answers."""

import numpy as np
import pytest

from psa_tpu.core.alphabet import encode as jax_encode
from psa_tpu.core.alphabet import encode_batch_padded as jax_encode_batch_padded
from psa_tpu.core.alphabet import validate as jax_validate
from psa_tpu.core.alphabet import validate_batch as jax_validate_batch
from psa_tpu.models import batch as jbatch
from psa_tpu.utils.io import Query as JaxQuery

from psa_torch import native
from psa_torch.core import alphabet
from psa_torch.core.alphabet import ALPHABET_ERROR, HYPHEN_CODE
from psa_torch.models import batch
from psa_torch.ops import sweep as sw
from psa_torch.utils import spans
from psa_torch.utils.io import Query

from conftest import random_seq

W = np.array([1.0, 3.0, 4.0, 2.0])

SEQS = {
    "every_byte": "".join(map(chr, range(256))),
    "empty": "",
    "valid": "ABCDEFGHIJKLMNOPQRSTUVWXYZ-" * 3,
    "lowercase": "abcxyz",
    "hyphens": "---A-Z---",
    "e_acute": "ABéCD",
    "euro": "€",
    "emoji": "A😀Z",
    "one_bad_last": "A" * 70 + "?",
    "long_valid": "QWERTY-" * 300,
    "long_bad_middle": "QWERTY-" * 150 + "q" + "QWERTY-" * 150,
}


@pytest.fixture(params=["native", "numpy"])
def engine(request, monkeypatch):
    """The native library's pass, or the fallback with the library off."""
    if request.param == "native":
        assert native.available()
    else:
        monkeypatch.setattr(native, "_available", False)
    return request.param


@pytest.mark.parametrize("name", sorted(SEQS))
def test_checked_pass_is_encode_and_validate(engine, name):
    seq = SEQS[name]
    before = native.calls["encode_checked"]
    codes, ok = alphabet.encode_checked(seq)
    assert native.calls["encode_checked"] == before + (engine == "native")
    assert codes.dtype == np.uint8 and codes.shape == (len(seq),)
    np.testing.assert_array_equal(codes, jax_encode(seq).astype(np.uint8))
    assert ok is jax_validate(seq)
    np.testing.assert_array_equal(alphabet.encode(seq), jax_encode(seq))
    assert alphabet.encode(seq).dtype == np.int32
    assert alphabet.validate(seq) is jax_validate(seq)


def test_every_byte_alone(engine):
    """Each byte 0-255 as bytes and as a one-character string (non-ASCII
    characters read as '?')."""
    for b in range(256):
        for seq in (bytes([b]), chr(b)):
            codes, ok = alphabet.encode_checked(seq)
            want = jax_encode(seq).astype(np.uint8)
            np.testing.assert_array_equal(codes, want, err_msg=repr(seq))
            assert ok is bool(want[0] <= HYPHEN_CODE), repr(seq)
        assert alphabet.validate(chr(b)) is jax_validate(chr(b)), b


def test_batch_checked_pass(engine):
    rng = np.random.default_rng(3)
    seqs = list(SEQS.values()) + [random_seq(rng, int(n))
                                  for n in rng.integers(0, 400, 30)]
    seqs[20] = seqs[20][:7] + "a" + seqs[20][8:]
    length = max(map(len, seqs)) + 5
    before = native.calls["encode_checked"]
    codes, ok = alphabet.encode_batch_checked(seqs, length)
    assert native.calls["encode_checked"] == before + (engine == "native")
    assert codes.dtype == np.uint8 and codes.shape == (len(seqs), length)
    np.testing.assert_array_equal(codes.view(np.int8),
                                  jax_encode_batch_padded(seqs, length))
    np.testing.assert_array_equal(ok, jax_validate_batch(seqs))
    np.testing.assert_array_equal(ok, [alphabet.validate(s) for s in seqs])
    assert not ok.all() and ok.any()
    with pytest.raises(ValueError, match="exceeds padded length"):
        alphabet.encode_batch_checked(seqs, length - 6)
    empty, ok0 = alphabet.encode_batch_checked([], 8)
    assert empty.shape == (0, 8) and ok0.shape == (0,)


# --- the batch front's strict-mode contract ---------------------------------

def mixed(rng, bad=()):
    """Six queries in two shapes, interleaved: a bucket of 900 x 120 (the
    even indices) first, then one of 400 x 60 (the odd), with the indices
    in `bad` made out of the alphabet."""
    qs = []
    for i in range(6):
        n1, n2 = (400, 60) if i % 2 else (900, 120)
        s1, s2 = random_seq(rng, n1), random_seq(rng, n2)
        if i in bad:
            s2 = s2[:10] + "x" + s2[11:]
        qs.append((s1, s2))
    return qs


def port_q(qs):
    return [Query(W, a, b, False) for a, b in qs]


def jax_q(qs):
    return [JaxQuery(W, a, b, False) for a, b in qs]


def work_done():
    """What a bucket leaves behind: its spans past the front, the launch
    counters and the native engines' calls."""
    work = ("upload", "launch", "fetch_wait", "host_select", "rescore",
            "search")
    return ([s.name for s in spans.records() if s.name in work],
            sw.launches_batched, sw.launches_batched_shared,
            native.calls["rescore_multi"], native.calls["search"])


@pytest.mark.parametrize("bad", [(0,), (3,), (5,), (4, 1), (2, 5, 3)])
@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_the_lowest_bad_case_before_any_bucket(monkeypatch, backend, bad):
    """The error names the lowest bad index over all queries, with the
    JAX package's text; with `auto` and a low threshold the 400 x 60
    bucket runs on the native engine after the device's 900 x 120 one
    (its bad cases are the odd ones).  Nothing runs before the raise."""
    if backend == "auto":
        monkeypatch.setattr(batch.CONFIG, "auto_threshold", 200_000)
    qs = mixed(np.random.default_rng(sum(bad)), bad)
    with pytest.raises(ValueError) as want:
        jbatch.search_batch(jax_q(qs), backend="numpy")
    was = spans.enable(True)
    try:
        spans.clear()
        before = work_done()
        for run in (batch.search_batch, batch.search_batch_async):
            with pytest.raises(ValueError) as got:
                run(port_q(qs), backend=backend, device="cpu")
            assert str(got.value) == str(want.value) == (
                f"case {min(bad)}: {ALPHABET_ERROR}")
        assert work_done() == before
    finally:
        spans.enable(was)
        spans.clear()


@pytest.mark.parametrize("backend,host_queries",
                         [("torch", 0), ("auto", 4), ("native", 7)])
def test_lenient_runs_a_bad_batch_to_the_jax_answers(monkeypatch, backend,
                                                     host_queries):
    """`auto`'s native engine takes the 400 x 60 bucket and the 300 x 40
    one."""
    monkeypatch.setattr(batch.CONFIG, "auto_threshold", 200_000)
    qs = mixed(np.random.default_rng(9), bad=(1, 4))
    qs.append(("?" * 300, "!" * 40))                 # no mutation at all
    before = native.calls["search"]
    got = batch.search_batch(port_q(qs), backend=backend, device="cpu",
                             strict_alphabet=False)
    assert native.calls["search"] == before + host_queries
    want = jbatch.search_batch(jax_q(qs), backend="numpy",
                               strict_alphabet=False)
    assert got[-1] is None and want[-1] is None
    assert [None if r is None else
            (r.offset, r.char_offset, r.sub_code, r.score) for r in got] == [
        None if r is None else
        (r.offset, r.char_offset, r.sub_code, r.score) for r in want]


@pytest.mark.parametrize("bad", [(), (5,)])
def test_the_alphabet_before_the_lengths(bad):
    """A Seq2 longer than its Seq1 (case 2) is refused after the alphabet
    check: a bad case's error comes first, as in the JAX package."""
    qs = mixed(np.random.default_rng(2), bad)
    qs[2] = (qs[2][1], qs[2][0])
    with pytest.raises(ValueError) as got:
        batch.search_batch(port_q(qs), device="cpu")
    if not bad:
        assert str(got.value) == "seq2 longer than seq1"
        return
    with pytest.raises(ValueError) as want:
        jbatch.search_batch(jax_q(qs), backend="numpy")
    assert str(got.value) == str(want.value) == f"case 5: {ALPHABET_ERROR}"
