"""Shared fixtures of the benchmark's tests: small traffic for CPU runs."""

import pytest

# every cell's mix at a size a CPU run holds in well under a second
SMALL = {"seq1_len": 3000, "seq2_len": 400}


@pytest.fixture
def small_mix():
    return dict(SMALL)
