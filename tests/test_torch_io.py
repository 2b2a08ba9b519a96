"""The port's chunk parser (psa_torch.utils.io.parse_query_lines) against
the JAX package's: every line gives the same entry (None for a blank line,
the same error string, or a Query with the same fields), through the native
scanner and with the Python path forced, on seeded and hypothesis-drawn
lines."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from psa_tpu import native as jnative
from psa_tpu.utils import io as jio

from psa_torch import native
from psa_torch.core.alphabet import ALPHABET_ERROR
from psa_torch.utils import io as tio

WEIGHT_TOKENS = ["1", "3", "4", "2", "0", "-0", "+.5", "1e999", "-1e999", "nan",
                 "NaN", "inf", "-Infinity", "0x1p3", "1_0", "1e-320", "2.5e3",
                 "7.", ".", "1,5", "abc", "١", "1.0e+2", "  "]
SEQ_TOKENS = ["ABCDEFGHIJ", "ABC", "A", "XYZ-", "abc", "ABCj", "AB*CD", "é",
              "ÀBC", "A" * 40, "--", "?!", "AB\x00C", "ABCDEFGHIJKLMNOPQRSTUVWXYZ"]
MODES = ["minimum", "maximum", "MAXIMUM", "max", "", "maximum extra"]
SEPS = [" ", "\t", "  ", " \t ", "\x0b", "\x0c", " ", " "]
ENDS = ["", "\n", "\r\n", "\r", " \n"]


def entry_key(e):
    """A comparable form of one entry: the Query's fields, with the weights
    as raw bytes (so -0.0 and NaN payloads compare too)."""
    if e is None or isinstance(e, str):
        return e
    return ("Q", np.asarray(e.weights, np.float64).tobytes(), e.seq1, e.seq2,
            bool(e.is_max))


def both(lines, check_alphabet, fast, monkeypatch):
    if not fast:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    got = [entry_key(e) for e in tio.parse_query_lines(lines, check_alphabet)]
    want = [entry_key(e) for e in jio.parse_query_lines(lines, check_alphabet)]
    return got, want


GOOD_WEIGHTS = ["1", "3", "4", "2", "0", "-0", "+.5", "0x1p3", "1_0", "2.5e3", "-7"]


def seeded_lines(seed, n=120):
    """Lines of 0-9 tokens: about half built to parse (good weights, Seq2
    no longer than Seq1, some out of the alphabet or lowercase), the rest
    drawn from every pool."""
    rng = np.random.default_rng(seed)

    def pick(pool):
        return pool[int(rng.integers(len(pool)))]

    lines = []
    for _ in range(n):
        if rng.random() < 0.5:
            s1 = pick(SEQ_TOKENS[:4] + SEQ_TOKENS[9:])
            toks = [pick(GOOD_WEIGHTS) for _ in range(4)]
            toks += [s1, s1[: int(rng.integers(1, len(s1) + 1))], pick(MODES)]
        else:
            toks = [pick(WEIGHT_TOKENS if i < 4 else SEQ_TOKENS if i < 6 else MODES)
                    for i in range(int(rng.integers(0, 10)))]
        sep = pick(SEPS)
        lead = " " * int(rng.integers(0, 2))
        lines.append(lead + sep.join(toks) + pick(ENDS))
    return lines


@pytest.mark.parametrize("fast", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("check_alphabet", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_seeded_lines_parse_alike(seed, check_alphabet, fast, monkeypatch):
    lines = seeded_lines(seed)
    before = native.calls["parse_chunk"]
    got, want = both(lines, check_alphabet, fast, monkeypatch)
    assert got == want
    assert native.calls["parse_chunk"] - before == (1 if fast else 0)
    assert any(isinstance(e, tuple) for e in got)
    assert any(isinstance(e, str) for e in got)


@pytest.mark.parametrize("fast", [True, False], ids=["native", "python"])
def test_precedence_of_the_errors(fast, monkeypatch):
    """Finite weights before the seq order, before the alphabet; too few
    tokens before everything."""
    lines = ["nan 3 4 2 AB ABCD minimum", "1 3 4 2 AB ABCD minimum",
             "1 3 4 1e999 ab abc minimum", "1 3 4 2 abc ab minimum",
             "1 3 4 2 ABCD a minimum", "nan 3 4", "", "\r\n", "1 3 4 2 ABCD AB"]
    got, want = both(lines, True, fast, monkeypatch)
    assert got == want
    finite = "weights must be finite (inf/nan rejected)"
    assert got == [finite, "seq2 must not be longer than seq1", finite,
                   ALPHABET_ERROR, ALPHABET_ERROR,
                   "input needs >= 7 whitespace-delimited tokens, got 3", None, None,
                   "input needs >= 7 whitespace-delimited tokens, got 6"]


@pytest.mark.parametrize("fast", [True, False], ids=["native", "python"])
def test_weights_spellings(fast, monkeypatch):
    """-0 keeps its sign, +.5, 0x1p3 and 1_0 parse as Python's float does,
    and an unparseable weight is Python's error text."""
    lines = [f"{w} 3 4 2 ABCDEFG ABC minimum"
             for w in ("-0", "+.5", "0x1p3", "1_0", "1e-320", "١", "1,5")]
    got, want = both(lines, True, fast, monkeypatch)
    assert got == want
    w0 = np.frombuffer(got[0][1], np.float64)
    assert w0[0] == 0.0 and np.signbit(w0[0])
    assert np.frombuffer(got[1][1], np.float64)[0] == 0.5
    assert isinstance(got[2], str) and isinstance(got[6], str)


def test_native_and_python_paths_agree(monkeypatch):
    lines = seeded_lines(11, 300)
    fast = [entry_key(e) for e in tio.parse_query_lines(lines)]
    monkeypatch.setattr(native, "available", lambda: False)
    assert [entry_key(e) for e in tio.parse_query_lines(lines)] == fast


def test_parse_chunk_native_refuses_spans_outside_the_buffer():
    with pytest.raises(ValueError):
        native.parse_chunk_native(b"1 2 3", np.array([0], np.int64),
                                  np.array([9], np.int32), True)


_token = st.one_of(st.sampled_from(WEIGHT_TOKENS + SEQ_TOKENS + MODES),
                   st.text(alphabet=st.sampled_from("ABCZ-az?é0123456789.eE+-_x"),
                           min_size=1, max_size=12),
                   st.floats(allow_nan=True, allow_infinity=True).map(repr))
_line = st.builds(
    lambda toks, sep, end, lead: lead + sep.join(toks) + end,
    st.lists(_token, min_size=0, max_size=9), st.sampled_from(SEPS),
    st.sampled_from(ENDS), st.sampled_from(["", " ", "\t"]))


@settings(max_examples=150, deadline=None)
@given(lines=st.lists(_line, min_size=1, max_size=12),
       check_alphabet=st.booleans())
def test_drawn_lines_parse_alike(lines, check_alphabet):
    want = [entry_key(e) for e in jio.parse_query_lines(lines, check_alphabet)]
    assert [entry_key(e) for e in tio.parse_query_lines(lines, check_alphabet)] == want
    assert [entry_key(e) for e in tio._parse_query_lines_py(lines, check_alphabet)] == want
