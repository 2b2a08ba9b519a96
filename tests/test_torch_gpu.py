"""Tests of the port that need the card: the CUDA sweep kernel against its
plain PyTorch version, and the engine on the card against the host oracle.
They skip without a CUDA device.  This file imports neither JAX nor psa_tpu,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from psa_torch.core.alphabet import OTHER_CODE
from psa_torch.core.tables import build_tables
from psa_torch.models.search import AlignmentSearchEngine
from psa_torch.ops import sweep as sw
from psa_torch.utils.generator import random_sequences

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def codes(rng, n, other):
    c = rng.integers(0, 27, n).astype(np.int32)
    if other:
        c[::7] = OTHER_CODE
    return c


@pytest.mark.parametrize("n1,n2,other", [(1000, 137, False), (131072, 8192, False),
                                         (400_000, 2048, False), (50_000, 3000, True)])
def test_kernel_matches_plain(cuda, n1, n2, other):
    """All 8 rows integer-equal to the plain version on the card."""
    rng = np.random.default_rng(n1 + n2)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    noff, noff_pad, l2p, l1k = sw.plan_shapes(n1, n2)
    d1 = sw.upload_codes(codes(rng, n1, other), l1k, cuda)
    d2 = sw.upload_codes(codes(rng, n2, other), l2p, cuda)
    code = torch.from_numpy(tables.code).to(cuda)
    before = sw.launches
    got = sw.sweep(d1, d2, code)
    torch.cuda.synchronize()
    assert sw.launches == before + 1
    assert torch.equal(got, sw.sweep_plain(d1, d2, code))


@pytest.mark.parametrize("weights,is_max", [((1.0, 3.0, 4.0, 2.0), False),
                                            ((2.0, 1.0, 5.0, 0.5), True),
                                            ((1.0, 1.0, 1.0, 1.0), True)])
def test_engine_on_card_matches_numpy(cuda, weights, is_max):
    rng = np.random.default_rng(17)
    c1, c2 = codes(rng, 9000, False), codes(rng, 700, False)
    got = AlignmentSearchEngine(weights, is_max).search_codes(c1, c2)
    want = AlignmentSearchEngine(weights, is_max, backend="numpy").search_codes(c1, c2)
    assert got == want


def test_north_star_on_card(cuda):
    s1, s2 = random_sequences(100_000, 10_000, seed=0)
    before = sw.launches
    res = AlignmentSearchEngine((1, 3, 4, 2), False).search(s1, s2)
    assert (res.offset, res.char_offset, res.sub_code, res.score) == (
        84944, 10, 10, -21596.0)
    assert sw.launches == before + 1
