"""Reproducible test-data generation.

Replaces the reference's unseeded `sequences_generator` (main.c:58-86: two
random A-Z sequences with len2 < len1) with a seeded generator; the same
seed gives the same sequences as the JAX package's generator, and
`psa-torch-gen` writes the same bytes as `psa-gen`."""

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


def make_workload(n1: int, n2: int, seed: int = 0,
                  weights=(1.0, 3.0, 4.0, 2.0), is_max: bool = False):
    """(weights, seq1, seq2, is_max) of one random query, for benches."""
    seq1, seq2 = random_sequences(n1, n2, seed=seed)
    return np.asarray(weights, np.float64), seq1, seq2, is_max


def main(argv: list[str] | None = None) -> int:
    """`psa-torch-gen`: write a reference-format input file of random
    sequences, one case record per seed (seed .. seed + cases - 1)."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="psa-torch-gen",
        description="generate a reference-format random input file")
    p.add_argument("n1", type=int, help="Seq1 length")
    p.add_argument("n2", type=int, help="Seq2 length (<= n1)")
    p.add_argument("-o", "--output", default="t.txt",
                   help="output path (default t.txt, like the reference)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hyphen-rate", type=float, default=0.0,
                   help="probability of '-' per position")
    p.add_argument("--weights", default="1 3 4 2",
                   help="four weights, space- or comma-separated")
    p.add_argument("--mode", default="minimum",
                   choices=["minimum", "maximum"])
    p.add_argument("--cases", type=int, default=1,
                   help="write N case records (seeds seed..seed+N-1) into "
                        "one file for `psa-torch --batch`")
    args = p.parse_args(argv)

    try:
        weights = [float(w) for w in args.weights.replace(",", " ").split()]
        if len(weights) != 4:
            raise ValueError
    except ValueError:
        print("error: --weights needs exactly 4 numbers", file=sys.stderr)
        return 2
    if args.n2 > args.n1:
        print("error: n2 must be <= n1", file=sys.stderr)
        return 2
    with open(args.output, "w") as f:
        for c in range(args.cases):
            s1, s2 = random_sequences(args.n1, args.n2, seed=args.seed + c,
                                      hyphen_p=args.hyphen_rate)
            f.write(" ".join("%g" % w for w in weights) + "\n")
            f.write(s1 + "\n" + s2 + "\n" + args.mode + "\n")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
