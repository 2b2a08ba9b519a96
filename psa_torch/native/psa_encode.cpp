// The port's own host loops, built into one library with psa_native.cpp
// (which stays a byte-for-byte copy of the JAX package's).
//
// Check while encoding: sequence bytes -> the kernels' uint8 codes and, in
// the same pass, whether any byte lies outside the alphabet.  The codes are
// core/alphabet's table ('A'..'Z' -> 0..25, '-' -> 26 HYPHEN_CODE, every
// other byte -> 27 OTHER_CODE), computed with byte masks instead of a table
// lookup so that the compiler vectorises the loop.

#include <cstdint>
#include <cstring>

namespace {

// One row: codes into `row`, the OR of the out-of-alphabet masks returned
// (0 when every byte is 'A'..'Z' or '-').
inline uint8_t encode_row(const uint8_t* __restrict src, int32_t m,
                          uint8_t* __restrict row) {
    uint8_t other_any = 0;
    for (int32_t k = 0; k < m; ++k) {
        const uint8_t c = src[k];
        const uint8_t v = static_cast<uint8_t>(c - 'A');
        const uint8_t letter = static_cast<uint8_t>(-(v < 26));
        const uint8_t hyphen = static_cast<uint8_t>(-(c == '-'));
        const uint8_t other = static_cast<uint8_t>(~(letter | hyphen));
        row[k] = static_cast<uint8_t>((v & letter) | (26 & hyphen) |
                                      (27 & other));
        other_any |= other;
    }
    return other_any;
}

}  // namespace

// (n, stride) PAD_CODE(28)-padded code rows from the byte strings
// rows[r][0, lens[r]) (ascii-replaced by the caller, so a non-ASCII
// character is one '?' byte), and bad[r] = 1 where row r holds an
// OTHER_CODE, else 0.
extern "C" void psa_encode_checked(const uint8_t* const* rows,
                                   const int32_t* lens, int32_t n,
                                   uint8_t* out, int32_t stride,
                                   uint8_t* bad) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (n > 64)
#endif
    for (int32_t r = 0; r < n; ++r) {
        uint8_t* row = out + static_cast<int64_t>(r) * stride;
        const int32_t m = lens[r];
        bad[r] = encode_row(rows[r], m, row) != 0;
        memset(row + m, 28, static_cast<size_t>(stride - m));  // PAD_CODE
    }
}
