"""Reproducible test-data generation.

Replaces the reference's unseeded `sequences_generator` (main.c:58-86: two
random A-Z sequences with len2 < len1) with a seeded generator; the same
seed gives the same sequences as the JAX package's generator."""

from __future__ import annotations

import numpy as np

from psa_torch.core.alphabet import decode


def random_sequences(n1: int, n2: int, seed: int = 0,
                     hyphen_p: float = 0.0) -> tuple[str, str]:
    if n2 > n1:
        raise ValueError("n2 must be <= n1")
    rng = np.random.default_rng(seed)

    def one(n):
        codes = rng.integers(0, 26, size=n, dtype=np.int32)
        if hyphen_p > 0:
            codes[rng.random(n) < hyphen_p] = 26
        return decode(codes)

    return one(n1), one(n2)


def write_input_file(path: str, weights, seq1: str, seq2: str, is_max: bool) -> None:
    with open(path, "w") as f:
        f.write(" ".join("%g" % w for w in weights) + "\n")
        f.write(seq1 + "\n")
        f.write(seq2 + "\n")
        f.write("maximum" if is_max else "minimum")
        f.write("\n")
