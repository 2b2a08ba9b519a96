"""The port's scoring tables against the JAX package's, field by field, and
the carry-across of a JAX table set into the port."""

import dataclasses

import numpy as np
import pytest
import torch

from psa_tpu.core.tables import build_tables as jax_build_tables
from psa_tpu.ops import select as jax_select

from psa_torch.core.tables import (ScoringTables, build_tables, device_tables,
                                   tables_from_arrays)
from psa_torch.ops import select

_RNG = np.random.default_rng(1234)
WEIGHTS = ([tuple(_RNG.uniform(-5, 5, 4)) for _ in range(4)]
           + [(1.0, 3.0, 4.0, 2.0), (2.0, 2.0, 2.0, 2.0), (1.0, 1.0, 1.0, 1.0),
              (0.0, 0.0, 0.0, 0.0), (5.0, 1.0, 1.0, 1.0), (1.0, 0.0, 1.0, 0.0)])


def assert_tables_equal(a, b):
    assert a.is_max == b.is_max
    for f in dataclasses.fields(ScoringTables):
        if f.name == "is_max":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("is_max", [True, False])
def test_build_tables_match_jax(weights, is_max):
    w = np.array(weights)
    port, jax_t = build_tables(w, is_max), jax_build_tables(w, is_max)
    assert_tables_equal(port, jax_t)
    fields = {f.name: getattr(jax_t, f.name)
              for f in dataclasses.fields(jax_t)}
    assert_tables_equal(tables_from_arrays(**fields), port)

    counts = _RNG.integers(0, 300, (50, 4))
    maxrank = _RNG.integers(-1, max(port.num_ranks, 1), 50)
    np.testing.assert_array_equal(
        select.totals_from_stats(counts, maxrank, port),
        jax_select.totals_from_stats(counts, maxrank, jax_t))
    assert (select.candidate_epsilon(port, 777)
            == jax_select.candidate_epsilon(jax_t, 777))


def test_tables_from_arrays_rejects_missing_fields():
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    fields = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    del fields["code"]
    with pytest.raises(ValueError):
        tables_from_arrays(**fields)


def test_device_tables():
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), True)
    d = device_tables(t, "cpu")
    assert d.code.dtype == torch.int8 and tuple(d.code.shape) == (32, 32)
    np.testing.assert_array_equal(d.code.numpy(), t.code)
    np.testing.assert_array_equal(d.w32.numpy(), t.w_signed.astype(np.float32))
    np.testing.assert_array_equal(d.diff32.numpy()[:-1],
                                  t.diff_vals.astype(np.float32))
    assert d.diff32[-1] == 0 and d.is_max
    assert d.eps(512) == float(np.float32(d.eps(512))) > 0
