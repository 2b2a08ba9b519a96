"""The work and the floors counted from the cells' shapes."""

import pytest

from psabench import peaks, registry, roofline


def test_pairs_and_floors_of_the_long_query():
    n1, n2 = 600_000, 250_000
    assert roofline.pairs(n1, n2) == 87_500_250_000          # 8.75e10
    assert roofline.operations(n1, n2) == 2 * 87_500_250_000
    assert roofline.ops_floor_s(n1, n2) * 1e6 == pytest.approx(88.43, abs=0.01)
    assert roofline.bytes_moved(n1, n2) == 850_000 + 32
    assert roofline.bytes_floor_s(n1, n2) * 1e6 == pytest.approx(0.2537, abs=1e-4)
    assert roofline.floor_s(n1, n2) == roofline.ops_floor_s(n1, n2)
    assert roofline.bound_by(n1, n2) == "operations"


@pytest.mark.parametrize("n1,n2,pairs", [(10, 10, 10), (10, 1, 10),
                                         (100_000, 10_000, 900_010_000),
                                         (5, 6, 0)])
def test_pairs_at_edges(n1, n2, pairs):
    assert roofline.pairs(n1, n2) == pairs


def test_a_query_without_pairs_is_bound_by_bytes():
    assert roofline.bound_by(1, 1) == "bytes"
    assert roofline.floor_s(1, 1) == roofline.bytes_floor_s(1, 1)


def test_peaks_name_their_source():
    assert peaks.INT8_OPS_PER_S == 1979e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    assert "H100" in peaks.SOURCE and "700 W" in peaks.SOURCE


@pytest.mark.parametrize("cell,pairs_per_call", [
    ("single.long_seq2", 87_500_250_000),
    ("batch.long_rows", 4 * 87_500_250_000)])
def test_pairs_per_call_of_each_cell(cell, pairs_per_call):
    mix = registry.traffic(registry.cell(cell)["traffic"])
    assert registry.driver(mix["kind"]).pairs_per_call(mix) == pairs_per_call
