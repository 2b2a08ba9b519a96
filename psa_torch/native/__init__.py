"""ctypes bindings for the native C++ host engine (psa_native.cpp and
psa_encode.cpp).

psa_native.cpp is a byte-for-byte copy of the JAX package's, so both
packages run the same host loops; psa_encode.cpp is the port's own (the
checked encode).  The shared library is built from both with g++ at first
use into psa_torch/_build/, named by the sources' hash and a CPU tag (it is
-march=native, so a binary built on another machine could SIGILL); it is
never committed.  After dlopen a small self-test runs against the port's
numpy oracle before the handle is trusted.

Callers that have a numpy path take it when `available()` is False; the
`native` backend raises instead.  `calls` counts the wrapper calls that went
through the library, so a run can show which host engine did the work.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

from psa_torch.core.result import NoMutationFound, SearchResult
from psa_torch.core.tables import ScoringTables
from psa_torch.utils import spans

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "psa_native.cpp")
_SOURCES = (_SRC, os.path.join(_DIR, "psa_encode.cpp"))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_available: bool | None = None

# wrapper calls answered by the library, by entry point
calls: collections.Counter = collections.Counter()
_calls_lock = threading.Lock()

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _count(name: str) -> None:
    with _calls_lock:
        calls[name] += 1


def _cpu_tag() -> str:
    """CPU-identity fingerprint: a build directory copied between machines
    must not hand one a binary built for another's ISA.  Virtual machines
    often share one model name over different instruction sets, so the
    feature flags are part of it."""
    ident = platform.machine()
    want = ["model name", ("flags", "Features")]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                for key in want:
                    if line.startswith(key):
                        ident += line
                        want.remove(key)
                        break
                if not want:
                    break
    except OSError:
        ident += platform.processor()
    return hashlib.sha256(ident.encode()).hexdigest()[:8]


def lib_path() -> str:
    """Where the library for these sources and this CPU is (or will be)."""
    h = hashlib.sha256()
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libpsa_host-{digest}-{_cpu_tag()}.so")


def _build(path: str) -> None:
    """g++ into a temporary file beside `path`, then one atomic rename, so
    processes that build at the same time never load a partial file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *_FLAGS, *_SOURCES, "-o", tmp],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("the native host engine needs g++") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the host library:\n"
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _self_test(lib) -> None:
    """One tiny end-to-end call; raises if the binary misbehaves."""
    from psa_torch.core.oracle import offset_stats_numpy
    from psa_torch.core.tables import build_tables

    t = build_tables(np.array([1.0, 2.0, 3.0, 4.0]), is_max=False)
    c1 = np.array([0, 1, 2, 3, 4], np.int32)   # ABCDE
    c2 = np.array([0, 1], np.int32)            # AB
    counts = np.empty((4, 4), np.int32)
    maxrank = np.empty(4, np.int32)
    lib.psa_offset_stats(c1, c2, 2,
                         np.ascontiguousarray(t.sign.reshape(-1)),
                         np.ascontiguousarray(t.rank.reshape(-1)),
                         0, 4, counts.reshape(-1), maxrank)
    ref_counts, ref_maxrank = offset_stats_numpy(c1, c2, t)
    codes, bad = np.empty(6, np.uint8), np.empty(2, np.uint8)
    lib.psa_encode_checked((ctypes.c_char_p * 2)(b"AZ-", b"a?"),
                           np.array([3, 2], np.int32), 2, codes, 3, bad)
    if not (np.array_equal(counts, ref_counts)
            and np.array_equal(maxrank, ref_maxrank)
            and codes.tolist() == [0, 25, 26, 27, 27, 28]
            and bad.tolist() == [0, 1]):
        raise RuntimeError("native library self-test failed")


def get_lib():
    """The loaded, self-tested library; builds it on first use.  Raises
    RuntimeError when g++ is missing, the build fails or the self-test
    fails, and OSError when the file cannot be loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with spans.span("native_load", built=0) as sp:
            _lib = _load(sp)
        return _lib


def _load(sp):
    """`get_lib`'s first call: the build when the file is missing (`sp`'s
    `built` set to 1), the load, the bindings and the self-test."""
    path = lib_path()
    if not os.path.exists(path):
        sp.set(built=1)
        _build(path)
    lib = ctypes.CDLL(path)
    lib.psa_search.restype = ctypes.c_int
    lib.psa_search.argtypes = [
        _i32p, ctypes.c_int32, _i32p, ctypes.c_int32,
        _f64p, _f64p, _i8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.psa_score_offset.restype = None
    lib.psa_score_offset.argtypes = [
        _i32p, _i32p, ctypes.c_int32,
        _f64p, _f64p, _i8p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.psa_offset_stats.restype = None
    lib.psa_offset_stats.argtypes = [
        _i32p, _i32p, ctypes.c_int32, _i8p, _i8p,
        ctypes.c_int32, ctypes.c_int32, _i32p, _i32p,
    ]
    lib.psa_parse_chunk.restype = None
    lib.psa_parse_chunk.argtypes = [
        ctypes.c_char_p, _i64p, _i32p, ctypes.c_int32, ctypes.c_int32,
        _i8p, _i32p, _f64p, _i8p, _i32p, _i32p, _i32p, _i32p,
    ]
    lib.psa_encode_checked.restype = None
    lib.psa_encode_checked.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), _i32p, ctypes.c_int32,
        _u8p, ctypes.c_int32, _u8p,
    ]
    lib.psa_rescore_multi.restype = None
    lib.psa_rescore_multi.argtypes = [
        _i32p, ctypes.c_int32, _i32p, ctypes.c_int32, _i32p,
        _f64p, _f64p, _i8p, ctypes.c_int32,
        _i32p, _i64p, ctypes.c_int32,
        _f64p, _i32p, _i32p,
    ]
    _self_test(lib)
    return lib


def available() -> bool:
    """Memoized build-and-self-test probe: one build attempt per process."""
    global _available
    if _available is None:
        try:
            get_lib()
            _available = True
        except (OSError, RuntimeError):
            _available = False
    return _available


def host_engine() -> str:
    """The engine host selection runs on: "native" or "numpy"."""
    return "native" if available() else "numpy"


def omp_max_threads() -> int:
    """The library's OpenMP thread count (what nthreads=0 uses)."""
    return int(get_lib().omp_get_max_threads())


def _flat_tables(tables: ScoringTables):
    pair_w = np.ascontiguousarray(tables.pair_w.reshape(-1))
    diff = np.ascontiguousarray(tables.diff.reshape(-1))
    sub = np.ascontiguousarray(tables.sub.reshape(-1))
    return pair_w, diff, sub


def search_native(codes1: np.ndarray, codes2: np.ndarray,
                  tables: ScoringTables, nthreads: int = 0,
                  first_offset: int = 0,
                  last_offset: int | None = None) -> SearchResult:
    """The whole search over offsets [first_offset, last_offset) with the
    reference's sequential semantics, on `nthreads` OpenMP threads (0 = all
    cores).  Releases the GIL while it runs."""
    lib = get_lib()
    codes1 = np.ascontiguousarray(codes1, np.int32)
    codes2 = np.ascontiguousarray(codes2, np.int32)
    noff = codes1.shape[0] - codes2.shape[0] + 1
    if last_offset is None:
        last_offset = noff
    if not (0 <= first_offset and last_offset <= noff):
        raise ValueError(f"offset range [{first_offset}, {last_offset}) "
                         f"outside [0, {noff})")
    pair_w, diff, sub = _flat_tables(tables)
    score = ctypes.c_double()
    off = ctypes.c_int32()
    coff = ctypes.c_int32()
    sc = ctypes.c_int32()
    _count("search")
    found = lib.psa_search(
        codes1, codes1.shape[0], codes2, codes2.shape[0],
        pair_w, diff, sub, int(tables.is_max), first_offset, last_offset,
        nthreads,
        ctypes.byref(score), ctypes.byref(off), ctypes.byref(coff),
        ctypes.byref(sc),
    )
    if not found:
        raise NoMutationFound("no offset admits a legal substitution")
    return SearchResult(offset=off.value, char_offset=coff.value,
                        sub_code=sc.value, score=score.value)


def score_offset_native(codes1: np.ndarray, codes2: np.ndarray,
                        tables: ScoringTables, offset: int):
    """One offset re-scored sequentially; the contract of
    core/oracle.score_offset_sequential."""
    lib = get_lib()
    codes1 = np.ascontiguousarray(codes1, np.int32)
    codes2 = np.ascontiguousarray(codes2, np.int32)
    if not 0 <= offset <= codes1.shape[0] - codes2.shape[0]:
        raise ValueError(f"offset {offset} out of range")
    pair_w, diff, sub = _flat_tables(tables)
    total = ctypes.c_double()
    coff = ctypes.c_int32()
    sc = ctypes.c_int32()
    _count("score_offset")
    lib.psa_score_offset(codes1, codes2, codes2.shape[0], pair_w, diff, sub,
                         int(tables.is_max), offset,
                         ctypes.byref(total), ctypes.byref(coff), ctypes.byref(sc))
    return total.value, coff.value, sc.value, None


def rescore_multi_native(c1b: np.ndarray, c2b: np.ndarray, n2s: np.ndarray,
                         tables: ScoringTables, qidx: np.ndarray,
                         offsets: np.ndarray):
    """Candidates of many queries re-scored in one call: candidate j is
    offset offsets[j] of query qidx[j], whose codes are row qidx[j] of the
    padded (B, L1) / (B, L2) matrices c1b / c2b.  The contract of
    core/oracle.rescore_multi, bit for bit.  Returns (totals f64,
    char_offsets i64, sub_codes i64)."""
    lib = get_lib()
    c1b = np.ascontiguousarray(c1b, np.int32)
    c2b = np.ascontiguousarray(c2b, np.int32)
    n2s = np.ascontiguousarray(n2s, np.int32)
    qidx = np.ascontiguousarray(qidx, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    if qidx.shape != offsets.shape:
        raise ValueError("qidx and offsets differ in length")
    if qidx.size:
        n2q = n2s[qidx]
        if not (0 <= qidx.min() and qidx.max() < c1b.shape[0]
                and c1b.shape[0] == c2b.shape[0] == n2s.shape[0]
                and n2q.max() <= c2b.shape[1] and offsets.min() >= 0
                and (offsets + n2q).max() <= c1b.shape[1]):
            raise ValueError("candidate out of its query's padded rows")
    pair_w, diff, sub = _flat_tables(tables)
    k = offsets.shape[0]
    totals = np.empty(k, np.float64)
    coffs = np.empty(k, np.int32)
    subs = np.empty(k, np.int32)
    _count("rescore_multi")
    lib.psa_rescore_multi(c1b, c1b.shape[1], c2b, c2b.shape[1], n2s,
                          pair_w, diff, sub, int(tables.is_max),
                          qidx, offsets, k, totals, coffs, subs)
    return totals, coffs.astype(np.int64), subs.astype(np.int64)


# Line statuses of parse_chunk_native (they must match psa_native.cpp).
PARSE_OK = 0
PARSE_BLANK = 1
PARSE_FEW_TOKENS = 2
PARSE_SEQ_ORDER = 3
PARSE_ALPHABET = 4
PARSE_FALLBACK = 5


def parse_chunk_native(buf: bytes, line_off: np.ndarray,
                       line_len: np.ndarray, check_alpha: bool):
    """One C pass over a chunk of protocol lines: tokenize, parse the
    weights, record the Seq1/Seq2 spans (offsets relative to each line's
    start) and the mode, and validate the alphabet when asked.  Lines the
    scanner cannot handle bit-identically to Python (non-ASCII, exotic
    float literals) come back as PARSE_FALLBACK, for the caller to parse
    with utils/io.parse_input.

    Returns (status, ntokens, weights (n, 4), is_max, s1_off, s1_len,
    s2_off, s2_len)."""
    lib = get_lib()
    n = line_off.shape[0]
    line_off = np.ascontiguousarray(line_off, np.int64)
    line_len = np.ascontiguousarray(line_len, np.int32)
    if line_len.shape != (n,):
        raise ValueError("line_off and line_len differ in length")
    if n and not (line_len.min() >= 0 and line_off.min() >= 0
                  and (line_off + line_len).max() <= len(buf)):
        raise ValueError("line span outside the buffer")
    status = np.empty(n, np.int8)
    ntokens = np.empty(n, np.int32)
    weights = np.empty((n, 4), np.float64)
    is_max = np.empty(n, np.int8)
    s1_off = np.empty(n, np.int32)
    s1_len = np.empty(n, np.int32)
    s2_off = np.empty(n, np.int32)
    s2_len = np.empty(n, np.int32)
    _count("parse_chunk")
    lib.psa_parse_chunk(buf, line_off, line_len, n, int(check_alpha),
                        status, ntokens, weights.reshape(-1), is_max,
                        s1_off, s1_len, s2_off, s2_len)
    return status, ntokens, weights, is_max, s1_off, s1_len, s2_off, s2_len


def encode_checked_native(raws: list, length: int):
    """(n, length) PAD-padded uint8 code rows of the byte strings `raws`,
    and each row's validity (every byte 'A'-'Z' or '-', no OTHER_CODE),
    from one C pass (core/alphabet.encode_checked's and
    encode_batch_checked's fast path)."""
    lib = get_lib()
    n = len(raws)
    lens = np.fromiter(map(len, raws), np.int32, n)
    if n and lens.max() > length:
        raise ValueError("a sequence is longer than the row")
    out = np.empty((n, length), np.uint8)
    bad = np.empty(n, np.uint8)
    _count("encode_checked")
    lib.psa_encode_checked((ctypes.c_char_p * n)(*raws), lens, n,
                           out.reshape(-1), length, bad)
    return out, bad == 0


def offset_stats_native(codes1: np.ndarray, codes2: np.ndarray,
                        tables: ScoringTables):
    """Per-offset (counts (noff, 4) int32, maxrank (noff,) int32), the
    contract of core/oracle.offset_stats_numpy."""
    lib = get_lib()
    codes1 = np.ascontiguousarray(codes1, np.int32)
    codes2 = np.ascontiguousarray(codes2, np.int32)
    noff = codes1.shape[0] - codes2.shape[0] + 1
    if noff <= 0:
        raise ValueError("seq2 longer than seq1")
    sign = np.ascontiguousarray(tables.sign.reshape(-1))
    rank = np.ascontiguousarray(tables.rank.reshape(-1))
    counts = np.empty((noff, 4), np.int32)
    maxrank = np.empty(noff, np.int32)
    _count("offset_stats")
    lib.psa_offset_stats(codes1, codes2, codes2.shape[0], sign, rank,
                         0, noff, counts.reshape(-1), maxrank)
    return counts, maxrank
