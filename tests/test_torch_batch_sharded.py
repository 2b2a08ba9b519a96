"""The port's sharded batch path (search_batch(mesh=...),
batched_search_exact_sharded) against the JAX package's search_batch on a
"dp" mesh of its virtual CPU devices (the Pallas batched kernels in
interpret mode) and against the port's own unsharded call.  The port's
meshes are lists of CPU devices, where the batched sweeps run their plain
versions.  Winners are exact tuples; every comparison is equality."""

import jax
import numpy as np
import pytest

from psa_tpu.models import batch as jbatch
from psa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from psa_tpu.utils.io import Query as JaxQuery

from psa_torch.core.tables import build_tables
from psa_torch.models import batch
from psa_torch.ops import sweep as sw
from psa_torch.utils import server
from psa_torch.utils.io import Query

from conftest import random_codes, random_seq

W = np.array([1.0, 3.0, 4.0, 2.0])


def astuple(r):
    return None if r is None else (r.offset, r.char_offset, r.sub_code, r.score)


def queries(rng):
    """Two per-row buckets (both modes), a shared-Seq1 bucket and a
    lenient no-mutation row."""
    qs = [(W, random_seq(rng, 400), random_seq(rng, 60), False) for _ in range(7)]
    qs += [(W, random_seq(rng, 700), random_seq(rng, 120), True) for _ in range(3)]
    ref = random_seq(rng, 900)
    qs += [(W, ref, random_seq(rng, 100), False) for _ in range(5)]
    qs.append((W, "#" * 400, "#" * 60, False))
    return qs


def port_q(qs):
    return [Query(np.asarray(w), a, b, m) for w, a, b, m in qs]


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_search_batch_matches_jax(n):
    qs = queries(np.random.default_rng(17))
    got = batch.search_batch(port_q(qs), strict_alphabet=False, mesh=["cpu"] * n)
    want = jbatch.search_batch([JaxQuery(np.asarray(w), a, b, m) for w, a, b, m in qs],
                               backend="pallas", strict_alphabet=False,
                               mesh=jax_make_mesh(jax.devices()[:n], axis="dp"))
    assert [astuple(r) for r in got] == [astuple(r) for r in want]
    assert got[-1] is None


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("micro_b", [None, 2])
def test_sharded_equals_unsharded(n, micro_b, monkeypatch):
    """Any mesh size and microbatch: uneven blocks (16 rows over 3, 8 and
    over microbatches of 2 x n) give the unsharded call's winners, in input
    order."""
    if micro_b:
        monkeypatch.setattr(batch.CONFIG, "micro_batch", micro_b)
    qs = port_q(queries(np.random.default_rng(19)))
    want = batch.search_batch(qs, strict_alphabet=False, device="cpu")
    got = batch.search_batch(qs, strict_alphabet=False, mesh=["cpu"] * n)
    assert got == want


def test_split_span_blocks():
    assert batch._split_span(0, 10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert batch._split_span(5, 7, 4) == [(5, 6), (6, 7), (7, 7), (7, 7)]
    assert batch._split_span(0, 1024, 4) == [(0, 256), (256, 512), (512, 768),
                                             (768, 1024)]


@pytest.mark.parametrize("shared", [False, True])
def test_one_batched_sweep_per_shard(shared, monkeypatch):
    """Each mesh device's block of a microbatch takes one batched sweep on
    that device (the shared-Seq1 kernel for a bucket on one Seq1); blocks
    left empty launch nothing."""
    rng = np.random.default_rng(23)
    ref = random_seq(rng, 500)
    qs = [Query(W, ref if shared else random_seq(rng, 500), random_seq(rng, 80), False)
          for _ in range(6)]
    want = batch.search_batch(qs, device="cpu")
    calls = []
    name = "sweep_batched_shared" if shared else "sweep_batched"
    real = getattr(batch, name)
    monkeypatch.setattr(batch, name,
                        lambda c1, c2b, code, counters=None: calls.append(
                            (c2b.shape[0], str(code.device))) or real(c1, c2b, code, counters))
    assert batch.search_batch(qs, mesh=["cpu"] * 4) == want
    assert calls == [(2, "cpu"), (2, "cpu"), (2, "cpu")]


def test_sharded_async_holds_fetches_per_block():
    rng = np.random.default_rng(29)
    qs = [Query(W, random_seq(rng, 300), random_seq(rng, 40), False) for _ in range(5)]
    handles, finish = batch.search_batch_async(qs, mesh=["cpu"] * 2)
    assert len(handles) == 2 and all(isinstance(h, batch.Fetch) for h in handles)
    assert finish() == batch.search_batch(qs, device="cpu")


def test_batched_search_exact_sharded_rows():
    """The array-level entry: padded code rows, a no-mutation row, results
    equal to batched_search_exact row for row."""
    rng = np.random.default_rng(31)
    n1, n2 = 700, 120
    noff, _, l2p, _ = sw.plan_shapes(n1, n2)
    noff_pad, l1k = sw.plan_bucket([noff], l2p)
    c1b = np.full((5, l1k), 28, np.uint8)
    c2b = np.full((5, l2p), 28, np.uint8)
    for q in range(5):
        c1b[q, :n1] = random_codes(rng, n1)
        c2b[q, :n2] = random_codes(rng, n2)
    c1b[2, :n1] = 27
    c2b[2, :n2] = 27
    noffs = np.full(5, noff, np.int32)
    n2s = np.full(5, n2, np.int32)
    t = build_tables(W, False)
    got = batch.batched_search_exact_sharded(c1b, c2b, noffs, n2s, t, ["cpu"] * 3)
    from psa_torch.core.tables import device_tables

    want = batch.batched_search_exact(c1b, c2b, noffs, n2s, device_tables(t, "cpu"))
    assert got == want and got[2] is None


def test_serve_chunk_on_a_mesh():
    """process_query_lines(mesh=) answers like the unsharded chunk."""
    rng = np.random.default_rng(37)
    lines = [f"1 3 4 2 {random_seq(rng, 300)} {random_seq(rng, 40)} minimum"
             for _ in range(6)] + ["bad", ""]
    want = server.process_query_lines(lines, backend="torch", lenient=False,
                                      json_out=False, device="cpu")[0]
    got = server.process_query_lines(lines, backend="torch", lenient=False,
                                     json_out=False, mesh=["cpu"] * 4)[0]
    assert got == want
