// Native host search engine (C++17 + OpenMP).
//
// Table-driven equivalent of the reference CPU engine (cpu_funcs.c:222-300):
// all pair logic comes from the precomputed tables built in Python
// (core/tables.py), the scan order and float semantics match the reference's
// sequential f64 accumulation, and the thread merge preserves the canonical
// tie-break (best score -> lowest offset -> lowest char position) by merging
// contiguous offset blocks in ascending order.
//
// Roles in the framework:
//  * bit-exact oracle for differential tests at native speed,
//  * CPU fallback backend ("--backend native"),
//  * fast candidate re-scorer for ops/select.py.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC psa_native.cpp -o _libpsa.so

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <locale.h>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int kNCodes = 29;

struct Best {
    double total;
    int32_t offset;
    int32_t char_offset;
    int32_t sub_code;
    bool found;
};

// Scan one offset exactly like find_best_mutant_offset (cpu_funcs.c:257-300):
// sequential f64 sum of pair weights; keep the first strictly-better diff.
inline void scan_offset(const int32_t* c1, const int32_t* c2, int n2,
                        const double* pair_w, const double* diff,
                        const int8_t* sub, bool is_max, int32_t offset,
                        double* out_total, int32_t* out_i, int32_t* out_sub) {
    double total = 0.0;
    double best_diff = is_max ? -std::numeric_limits<double>::infinity()
                              : std::numeric_limits<double>::infinity();
    int32_t best_i = -1;
    int32_t best_sub = -1;
    const int32_t* win = c1 + offset;
    for (int i = 0; i < n2; ++i) {
        const int idx = win[i] * kNCodes + c2[i];
        total += pair_w[idx];
        const double d = diff[idx];
        if (std::isnan(d)) continue;
        if ((is_max && d > best_diff) || (!is_max && d < best_diff)) {
            best_diff = d;
            best_i = i;
            best_sub = sub[idx];
        }
    }
    if (best_i < 0) {
        *out_total = best_diff;  // +-inf: offset can never win (cpu_funcs.c:297)
        *out_i = -1;
        *out_sub = -1;
        return;
    }
    *out_total = total + best_diff;
    *out_i = best_i;
    *out_sub = best_sub;
}

// is_swapable (cuda_funcs.cu:290-307): strictly better score, else lower
// offset, else lower char offset.
inline bool better(const Best& cur, const Best& cand, bool is_max) {
    if (!cand.found) return false;
    if (!cur.found) return true;
    if ((is_max && cand.total > cur.total) || (!is_max && cand.total < cur.total))
        return true;
    if (cand.total == cur.total) {
        if (cand.offset < cur.offset) return true;
        if (cand.offset == cur.offset && cand.char_offset < cur.char_offset)
            return true;
    }
    return false;
}

}  // namespace

extern "C" {

// Full search over [first_offset, last_offset). Returns 1 when a mutation was
// found, 0 otherwise.
int psa_search(const int32_t* codes1, int32_t n1,
               const int32_t* codes2, int32_t n2,
               const double* pair_w, const double* diff, const int8_t* sub,
               int32_t is_max, int32_t first_offset, int32_t last_offset,
               int32_t nthreads,
               double* out_score, int32_t* out_offset,
               int32_t* out_char_offset, int32_t* out_sub_code) {
    (void)n1;
    const bool maxm = is_max != 0;
    const int32_t total = last_offset - first_offset;
    if (total <= 0) return 0;

#if defined(_OPENMP)
    const int nt = nthreads > 0 ? nthreads : omp_get_max_threads();
#else
    const int nt = 1;
#endif
    // Contiguous ascending blocks per thread (like cpu_funcs.c:192-196), so
    // the ordered merge below reproduces the global tie-break exactly.
    Best* results = new Best[nt];

#if defined(_OPENMP)
#pragma omp parallel num_threads(nt)
#endif
    {
#if defined(_OPENMP)
        const int tid = omp_get_thread_num();
#else
        const int tid = 0;
#endif
        const int32_t per = total / nt;
        const int32_t lo = first_offset + per * tid;
        const int32_t hi = (tid == nt - 1) ? last_offset : lo + per;
        Best local{0.0, -1, -1, -1, false};
        for (int32_t o = lo; o < hi; ++o) {
            double t;
            int32_t ci, sc;
            scan_offset(codes1, codes2, n2, pair_w, diff, sub, maxm, o,
                        &t, &ci, &sc);
            if (ci < 0) continue;
            Best cand{t, o, ci, sc, true};
            if (better(local, cand, maxm)) local = cand;
        }
        results[tid] = local;
    }

    Best best{0.0, -1, -1, -1, false};
    for (int t = 0; t < nt; ++t)
        if (better(best, results[t], maxm)) best = results[t];
    delete[] results;

    if (!best.found) return 0;
    *out_score = best.total;
    *out_offset = best.offset;
    *out_char_offset = best.char_offset;
    *out_sub_code = best.sub_code;
    return 1;
}

// Sequential re-scorer for one offset (candidate verification in select.py).
void psa_score_offset(const int32_t* codes1, const int32_t* codes2, int32_t n2,
                      const double* pair_w, const double* diff, const int8_t* sub,
                      int32_t is_max, int32_t offset,
                      double* out_total, int32_t* out_char_offset,
                      int32_t* out_sub_code) {
    scan_offset(codes1, codes2, n2, pair_w, diff, sub, is_max != 0, offset,
                out_total, out_char_offset, out_sub_code);
}

// Batch sequential re-scorer: scan_offset over an arbitrary candidate list
// (ops/select.pick_from_candidates).  OpenMP across candidates; each
// candidate's f64 accumulation stays sequential, so results are
// bit-identical to per-offset psa_score_offset calls.
void psa_rescore_batch(const int32_t* codes1, const int32_t* codes2,
                       int32_t n2, const double* pair_w, const double* diff,
                       const int8_t* sub, int32_t is_max,
                       const int64_t* offsets, int32_t n_cand,
                       double* out_totals, int32_t* out_char_offsets,
                       int32_t* out_sub_codes) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (n_cand > 16)
#endif
    for (int32_t k = 0; k < n_cand; ++k) {
        scan_offset(codes1, codes2, n2, pair_w, diff, sub, is_max != 0,
                    static_cast<int32_t>(offsets[k]),
                    &out_totals[k], &out_char_offsets[k], &out_sub_codes[k]);
    }
}

// Multi-query batch re-scorer: one call re-scores candidates drawn from B
// different queries (models/batch.batched_search_exact).  Query q's codes
// live at row q of the padded (B, l1_stride) / (B, l2_stride) matrices the
// batch path already has contiguous; each candidate k names its query via
// qidx[k].  Bit-identical to per-query psa_rescore_batch calls — the ~190us
// of per-query Python/ctypes overhead those cost at B=1000 was ~44% of the
// whole exact batch wall time.
void psa_rescore_multi(const int32_t* c1b, int32_t l1_stride,
                       const int32_t* c2b, int32_t l2_stride,
                       const int32_t* n2s,
                       const double* pair_w, const double* diff,
                       const int8_t* sub, int32_t is_max,
                       const int32_t* qidx, const int64_t* offsets,
                       int32_t n_cand,
                       double* out_totals, int32_t* out_char_offsets,
                       int32_t* out_sub_codes) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (n_cand > 16)
#endif
    for (int32_t k = 0; k < n_cand; ++k) {
        const int32_t q = qidx[k];
        scan_offset(c1b + static_cast<int64_t>(q) * l1_stride,
                    c2b + static_cast<int64_t>(q) * l2_stride, n2s[q],
                    pair_w, diff, sub, is_max != 0,
                    static_cast<int32_t>(offsets[k]),
                    &out_totals[k], &out_char_offsets[k], &out_sub_codes[k]);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native wire path: the serving front-end's per-chunk host work.
//
// The serve loops (utils/server.py) turn thousands of protocol lines into
// device batches per chunk; the measured host cost of the Python pipeline
// (per 1024-query chunk of 2048x512: parse 5.7 ms + alphabet validation
// 10.4 ms + padded encode 9.9 ms + 5-bit wire pack 4.8 ms) bounds serving
// throughput once the device round trip stops dominating (directly-attached
// TPU: ~6.4 us/query device time).  These three entry points fuse that work
// into single C passes over the chunk bytes.  Anything a simple byte-level
// scanner cannot reproduce bit-identically to Python semantics (non-ASCII
// lines, exotic float literals) is flagged for a per-line Python fallback
// rather than approximated — the protocol contract stays defined by the
// Python implementation.
// ---------------------------------------------------------------------------

namespace {

// Python str.split() whitespace, restricted to ASCII (non-ASCII lines are
// routed to the Python fallback before reaching this code): space, \t-\r,
// and the separator controls \x1c-\x1f (Py_UNICODE_ISSPACE includes them).
inline bool is_py_space(uint8_t c) {
    return c == ' ' || (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x1F);
}

// Characters for which glibc strtod acceptance/value provably matches
// Python float() on a full-token parse.  Everything else (inf/nan spellings,
// hex floats, digit underscores) falls back to Python.
inline bool is_simple_float_char(uint8_t c) {
    return (c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.' ||
           c == 'e' || c == 'E';
}

struct EncTable { int8_t t[256]; };

const int8_t* enc_table() {
    // C++11 magic static: thread-safe one-time init (psa_parse_chunk calls
    // this from inside an OpenMP-parallel loop; a plain `static bool init`
    // flag would be a formal data race on first concurrent use).
    static const EncTable tab = [] {
        EncTable e;
        for (int i = 0; i < 256; ++i) e.t[i] = 27;     // OTHER_CODE
        for (int i = 0; i < 26; ++i) e.t['A' + i] = static_cast<int8_t>(i);
        e.t[static_cast<unsigned char>('-')] = 26;      // HYPHEN_CODE
        return e;
    }();
    return tab.t;
}

// strtod is LC_NUMERIC-dependent: an embedding process with a comma-decimal
// locale would reject every '.'-decimal weight token (conservative — the
// line degrades to Python fallback — but it silently kills the fast path).
// Parse against a cached "C" numeric locale so acceptance and value are
// locale-independent by construction.  newlocale failure (0) falls back to
// plain strtod.  newlocale/strtod_l as used here are POSIX.2008+glibc; on
// other platforms (macOS wants <xlocale.h>, MSVC spells it _strtod_l) the
// guard below falls back to plain strtod, which the lc==0 path already
// handles — correctness is unchanged, only locale-independence is lost on
// exotic-locale embedders there.
#if defined(__GLIBC__)
locale_t c_numeric_locale() {
    static const locale_t loc =
        newlocale(LC_NUMERIC_MASK, "C", static_cast<locale_t>(0));
    return loc;
}
#else
typedef int psa_no_locale_t;
static inline psa_no_locale_t c_numeric_locale() { return 0; }
static inline double strtod_l(const char*, char**, psa_no_locale_t) {
    return 0.0;  // unreachable: callers test lc before calling
}
#endif

}  // namespace

extern "C" {

// Line statuses (must match psa_tpu/native/__init__.py):
//   0 ok   1 blank   2 too-few-tokens (ntokens set)   3 seq2 longer than
//   seq1   4 out-of-alphabet sequence   5 needs-Python-fallback
//
// One pass per line over the chunk buffer: tokenize (Python str.split
// semantics), parse the 4 weight tokens with strtod (full-consumption
// check), record Seq1/Seq2 spans (offsets RELATIVE to the line start),
// compare the mode token to "maximum", and optionally validate sequence
// characters (A-Z and '-', matching core/alphabet.validate).  Lines are
// independent -> OpenMP.
void psa_parse_chunk(const uint8_t* buf, const int64_t* line_off,
                     const int32_t* line_len, int32_t nlines,
                     int32_t check_alpha,
                     int8_t* status, int32_t* ntokens,
                     double* weights /* (nlines,4) */, int8_t* is_max,
                     int32_t* s1_off, int32_t* s1_len,
                     int32_t* s2_off, int32_t* s2_len) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (nlines > 64)
#endif
    for (int32_t j = 0; j < nlines; ++j) {
        const uint8_t* line = buf + line_off[j];
        const int32_t len = line_len[j];
        status[j] = 0;
        ntokens[j] = 0;
        is_max[j] = 0;

        // Non-ASCII bytes mean the str<->byte index equivalence (and the
        // ASCII whitespace model) no longer holds: Python handles the line.
        bool ascii = true;
        for (int32_t i = 0; i < len; ++i)
            if (line[i] >= 0x80) { ascii = false; break; }
        if (!ascii) { status[j] = 5; continue; }

        // Tokenize: first 7 token spans; stop after the 7th (tokens past
        // the mode are ignored, utils/io.parse_input / cpu_funcs.c:353-368).
        int32_t tok_off[7], tok_len[7];
        int nt = 0;
        int32_t i = 0;
        while (i < len && nt < 7) {
            while (i < len && is_py_space(line[i])) ++i;
            if (i >= len) break;
            const int32_t start = i;
            while (i < len && !is_py_space(line[i])) ++i;
            tok_off[nt] = start;
            tok_len[nt] = i - start;
            ++nt;
        }
        if (nt == 0) { status[j] = 1; continue; }
        if (nt < 7) {
            // error message needs the FULL token count of the line
            while (i < len) {
                while (i < len && is_py_space(line[i])) ++i;
                if (i >= len) break;
                ++nt;
                while (i < len && !is_py_space(line[i])) ++i;
            }
            status[j] = 2;
            ntokens[j] = nt;
            continue;
        }
        ntokens[j] = 7;

        bool fallback = false;
        for (int w = 0; w < 4 && !fallback; ++w) {
            const int32_t tl = tok_len[w];
            if (tl <= 0 || tl > 63) { fallback = true; break; }
            char tmp[64];
            for (int32_t k = 0; k < tl; ++k) {
                const uint8_t c = line[tok_off[w] + k];
                if (!is_simple_float_char(c)) { fallback = true; break; }
                tmp[k] = static_cast<char>(c);
            }
            if (fallback) break;
            tmp[tl] = '\0';
            char* end = nullptr;
            const auto lc = c_numeric_locale();  // locale_t, or the no-op
            const double v = lc ? strtod_l(tmp, &end, lc)  // int stand-in
                                : strtod(tmp, &end);
            if (end != tmp + tl) { fallback = true; break; }
            weights[4 * static_cast<int64_t>(j) + w] = v;
        }
        if (fallback) { status[j] = 5; continue; }

        s1_off[j] = tok_off[4];
        s1_len[j] = tok_len[4];
        s2_off[j] = tok_off[5];
        s2_len[j] = tok_len[5];
        is_max[j] = (tok_len[6] == 7 &&
                     memcmp(line + tok_off[6], "maximum", 7) == 0);
        if (tok_len[5] > tok_len[4]) { status[j] = 3; continue; }
        if (check_alpha) {
            const int8_t* enc = enc_table();
            bool ok = true;
            for (int s = 4; s < 6 && ok; ++s)
                for (int32_t k = 0; k < tok_len[s]; ++k)
                    if (enc[line[tok_off[s] + k]] > 26) { ok = false; break; }
            if (!ok) { status[j] = 4; continue; }
        }
    }
}

// Batch padded encode: sequence bytes (already ascii-replaced by the caller,
// matching core/alphabet.encode_batch_padded) -> (n, stride) int8 code rows,
// PAD_CODE(28)-filled tails, in one pass.  Replaces the numpy gather + the
// per-row Python copy loop.
void psa_encode_padded(const uint8_t* buf, const int64_t* offs,
                       const int32_t* lens, int32_t n,
                       int8_t* out, int32_t stride) {
    const int8_t* enc = enc_table();
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (n > 64)
#endif
    for (int32_t r = 0; r < n; ++r) {
        int8_t* row = out + static_cast<int64_t>(r) * stride;
        const uint8_t* src = buf + offs[r];
        const int32_t m = lens[r];
        for (int32_t k = 0; k < m; ++k) row[k] = enc[src[k]];
        memset(row + m, 28, static_cast<size_t>(stride - m));  // PAD_CODE
    }
}

// 5-bit wire pack: (b, n) int8 codes -> (b, ceil(n/6)) int32 words, 6 codes
// per word (models/batch.pack_code_rows).  Codes are <= 28 < 32; tail slots
// pack PAD_CODE so the in-graph unpack sees inert padding.
void psa_pack5(const int8_t* codes, int32_t b, int32_t n, int32_t* out) {
    const int32_t w = (n + 5) / 6;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (b > 64)
#endif
    for (int32_t r = 0; r < b; ++r) {
        const int8_t* row = codes + static_cast<int64_t>(r) * n;
        int32_t* dst = out + static_cast<int64_t>(r) * w;
        for (int32_t i = 0; i < w; ++i) {
            int32_t word = 0;
            const int32_t base = i * 6;
            for (int32_t k = 0; k < 6; ++k) {
                const int32_t p = base + k;
                const int32_t c = (p < n) ? row[p] : 28;  // PAD_CODE
                word |= c << (5 * k);
            }
            dst[i] = word;
        }
    }
}

}  // extern "C"

extern "C" {

// Per-offset integer stats (counts of 4 sign classes + max rank), matching
// the device engines' contract — lets tests diff device output against
// native output on large inputs quickly.
void psa_offset_stats(const int32_t* codes1, const int32_t* codes2,
                      int32_t n2, const int8_t* sign, const int8_t* rank,
                      int32_t first_offset, int32_t last_offset,
                      int32_t* out_counts /* (noff,4) */,
                      int32_t* out_maxrank /* (noff,) */) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int32_t o = first_offset; o < last_offset; ++o) {
        const int32_t* win = codes1 + o;
        int32_t c[4] = {0, 0, 0, 0};
        int32_t mr = -1;
        for (int i = 0; i < n2; ++i) {
            const int idx = win[i] * kNCodes + codes2[i];
            const int s = sign[idx];
            if (s < 4) ++c[s];
            const int r = rank[idx];
            if (r > mr) mr = r;
        }
        int32_t* row = out_counts + 4 * (o - first_offset);
        row[0] = c[0]; row[1] = c[1]; row[2] = c[2]; row[3] = c[3];
        out_maxrank[o - first_offset] = mr;
    }
}

}  // extern "C"
