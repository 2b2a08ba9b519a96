"""The host backends built on the native library (native, auto, hybrid), the
CLI's --backend, --threads and --device-share, and the batch path's
per-bucket routing, on the CPU (`device="cpu"`: the device half runs the
kernels' plain versions) against the JAX package's native and numpy
engines.  The hybrid cases are those of the JAX package's
tests/test_hybrid.py."""

import numpy as np
import pytest

from psa_tpu.models import batch as jbatch
from psa_tpu.models.search import AlignmentSearchEngine as JaxEngine
from psa_tpu.utils import cli as jax_cli
from psa_tpu.utils.io import Query as JaxQuery

from psa_torch import native
from psa_torch.core.result import NoMutationFound
from psa_torch.models import batch
from psa_torch.models import search as search_mod
from psa_torch.models.search import AlignmentSearchEngine, resolve_auto
from psa_torch.utils import cli
from psa_torch.utils.generator import random_sequences, write_input_file
from psa_torch.utils.io import Query

from conftest import random_codes, random_seq

W = np.array([1.0, 3.0, 4.0, 2.0])


def winner(res):
    return None if res is None else (res.offset, res.char_offset, res.sub_code, res.score)


def hybrid(is_max, share, **kw):
    return AlignmentSearchEngine(W, is_max, backend="hybrid", device="cpu",
                                 device_share=share, **kw)


def jax_winners(c1, c2, is_max, weights=W):
    """psa_tpu's native and numpy engines, which must agree."""
    a = JaxEngine(weights, is_max, backend="native").search_codes(c1, c2)
    b = JaxEngine(weights, is_max, backend="numpy").search_codes(c1, c2)
    assert winner(a) == winner(b)
    return winner(a)


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("share", [0, 37, 100])
def test_hybrid_matches_jax_full_range(is_max, share):
    rng = np.random.default_rng(1000 + share + is_max)
    c1, c2 = random_codes(rng, 1500), random_codes(rng, 300)
    got = hybrid(is_max, share).search_codes(c1, c2)
    assert winner(got) == jax_winners(c1, c2, is_max)


def test_hybrid_tie_prefers_device_block():
    """Every window is the same, so every offset ties: the lower offset, in
    the device block [0, split), must win the merge."""
    c1 = np.zeros(900, np.int32)
    c2 = np.zeros(200, np.int32)
    for is_max in (False, True):
        res = hybrid(is_max, 50).search_codes(c1, c2)
        assert res.offset == 0
        assert winner(res) == jax_winners(c1, c2, is_max)


def test_hybrid_winner_in_host_block():
    """A strictly better window deep in the host block's offsets."""
    rng = np.random.default_rng(7)
    c2 = random_codes(rng, 120, hyphen_p=0.0)
    c1 = random_codes(rng, 1200, hyphen_p=0.0)
    c1[1000:1120] = c2                      # a perfect match at offset 1000
    got = hybrid(True, 25).search_codes(c1, c2)     # split 270 < 1000
    assert got.offset == 1000
    assert winner(got) == jax_winners(c1, c2, True)


def test_hybrid_no_mutation_raises():
    c1 = np.full(700, 27, np.int32)
    c2 = np.full(150, 27, np.int32)
    with pytest.raises(NoMutationFound):
        hybrid(True, 50, strict_alphabet=False).search_codes(c1, c2)


@pytest.mark.parametrize("threshold,device_side", [(10**12, False), (1, True)])
def test_hybrid_auto_share_uses_crossover(monkeypatch, threshold, device_side):
    """device_share=None: all host below the threshold, all device at or
    above it."""
    monkeypatch.setattr(search_mod.CONFIG, "auto_threshold", threshold)
    rng = np.random.default_rng(11)
    c1, c2 = random_codes(rng, 800), random_codes(rng, 200)
    before = dict(native.calls)
    got = hybrid(False, None).search_codes(c1, c2)
    assert winner(got) == jax_winners(c1, c2, False)
    used_search = native.calls["search"] - before.get("search", 0)
    assert used_search == (0 if device_side else 1)


@pytest.mark.parametrize("threshold,want", [(10**12, "native"), (1, "torch")])
def test_auto_routes_by_threshold(monkeypatch, threshold, want):
    monkeypatch.setattr(search_mod.CONFIG, "auto_threshold", threshold)
    assert resolve_auto(800, 200) == want
    rng = np.random.default_rng(12)
    c1, c2 = random_codes(rng, 800), random_codes(rng, 200)
    before = native.calls["search"]
    got = AlignmentSearchEngine(W, True, backend="auto", device="cpu").search_codes(c1, c2)
    assert (native.calls["search"] - before == 1) == (want == "native")
    assert winner(got) == jax_winners(c1, c2, True)


def test_auto_threshold_is_pair_evals():
    t = search_mod.CONFIG.auto_threshold
    assert search_mod.pair_evals(1000, 100) == 901 * 100
    assert search_mod.pair_evals(10, 20) == 0
    assert resolve_auto(t, 1) == "torch"            # t pair-evals: the card
    assert resolve_auto(t - 1, 1) == "native"


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_native_backend_threads(threads):
    rng = np.random.default_rng(13)
    c1, c2 = random_codes(rng, 2000), random_codes(rng, 150)
    eng = AlignmentSearchEngine((2.0, 1.0, 5.0, 0.5), True, backend="native",
                                nthreads=threads)
    assert eng.device is None
    assert winner(eng.search_codes(c1, c2)) == jax_winners(
        c1, c2, True, np.array([2.0, 1.0, 5.0, 0.5]))


def batch_queries():
    rng = np.random.default_rng(77)
    qs = []
    for n1, n2, is_max in [(300, 40, False), (300, 40, True), (900, 200, False),
                           (1501, 77, False), (300, 40, False), (2600, 300, True)]:
        qs.append((random_seq(rng, n1), random_seq(rng, n2), is_max))
    ref = random_seq(rng, 1200)
    qs += [(ref, random_seq(rng, n2), True) for n2 in (60, 50, 64)]
    return qs


@pytest.mark.parametrize("threshold", [1, 100_000, 10**12])
def test_search_batch_auto_routes_buckets(monkeypatch, threshold):
    """Each bucket goes to the native engine when its pair-evals fall below
    the threshold, to the device otherwise; the winners are psa_tpu's."""
    monkeypatch.setattr(batch.CONFIG, "auto_threshold", threshold)
    qs = batch_queries()
    device_buckets = []
    real = batch.batched_search_exact
    monkeypatch.setattr(batch, "batched_search_exact",
                        lambda c1b, *a, **k: device_buckets.append(len(c1b))
                        or real(c1b, *a, **k))
    before = native.calls["search"]
    got = batch.search_batch([Query(W, a, b, m) for a, b, m in qs],
                             backend="auto", device="cpu")
    want = jbatch.search_batch([JaxQuery(W, a, b, m) for a, b, m in qs],
                               backend="numpy")
    assert [winner(r) for r in got] == [winner(r) for r in want]
    on_host = native.calls["search"] - before
    assert on_host + sum(device_buckets) == len(qs)
    if threshold == 1:
        assert on_host == 0
    elif threshold == 10**12:
        assert device_buckets == []
    else:                   # the small buckets on the host, the big on the card
        assert 0 < on_host < len(qs) and device_buckets


@pytest.mark.parametrize("backend", ["native", "hybrid"])
def test_search_batch_native_and_hybrid(backend):
    qs = batch_queries()
    if backend == "hybrid":
        with pytest.raises(ValueError, match="single-query"):
            batch.search_batch([Query(W, a, b, m) for a, b, m in qs],
                               backend=backend, device="cpu")
        return
    got = batch.search_batch([Query(W, a, b, m) for a, b, m in qs], backend=backend)
    want = jbatch.search_batch([JaxQuery(W, a, b, m) for a, b, m in qs],
                               backend="native")
    assert [winner(r) for r in got] == [winner(r) for r in want]


CLI_BACKENDS = [["--backend", "native"], ["--backend", "auto", "--device", "cpu"],
                ["--backend", "hybrid", "--device", "cpu"],
                ["--backend", "hybrid", "--device-share", "50", "--device", "cpu"],
                ["--device-share", "37", "--device", "cpu"],
                ["--device-share", "-100"], ["--backend", "native", "--threads", "2"],
                ["--device-share", "100", "--device", "cpu", "--json"]]


@pytest.mark.parametrize("extra", CLI_BACKENDS, ids=lambda a: " ".join(a))
@pytest.mark.parametrize("is_max", [False, True])
def test_cli_backends_bytes_match_psa_numpy(tmp_path, capsys, extra, is_max):
    s1, s2 = random_sequences(2500, 300, seed=4 + is_max, hyphen_p=0.05)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), (2.0, 1.0, 5.0, 0.5), s1, s2, is_max)
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert cli.main([str(inp), "-o", str(a), "--quiet", *extra]) == 0
    capsys.readouterr()
    assert jax_cli.main([str(inp), "-o", str(b), "--quiet", "--backend", "numpy"]) == 0
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("argv", [
    ["--device-share", "150"], ["--device-share", "-5"],
    ["--device-share", "50", "--backend", "native"],
    ["--device-share", "50", "--backend", "torch"],
    ["--device-share", "50", "--batch"], ["--backend", "hybrid", "--batch"]])
def test_cli_device_share_validation(tmp_path, capsys, argv):
    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2 ABCDEFGH CDE minimum\n")
    assert cli.main([str(inp), "-o", str(tmp_path / "o.txt"), "--device", "cpu",
                     *argv]) == 2
    assert "error" in capsys.readouterr().err
    assert not (tmp_path / "o.txt").exists()


@pytest.mark.parametrize("backend", ["auto", "native"])
def test_cli_batch_backends_match_psa_numpy(tmp_path, capsys, backend):
    from psa_torch.utils import generator

    cases = tmp_path / "cases.txt"
    parts = []
    for i, args in enumerate([["700", "120", "--cases", "3", "--seed", "4"],
                              ["900", "130", "--cases", "2", "--mode", "maximum",
                               "--weights", "2,1,5,0.5"]]):
        part = tmp_path / f"part{i}.txt"
        assert generator.main([*args, "-o", str(part)]) == 0
        parts.append(part.read_text())
    cases.write_text("".join(parts) + "1 3 4 2\n" + "?" * 300 + "\n!!!\nmaximum\n")
    rc = cli.main([str(cases), "--batch", "--backend", backend, "--device", "cpu",
                   "--lenient", "--quiet", "-o", str(tmp_path / "outs")])
    jrc = jax_cli.main([str(cases), "--batch", "--backend", "numpy", "--lenient",
                        "--quiet", "-o", str(tmp_path / "outs2")])
    capsys.readouterr()
    assert rc == jrc == 1
    names = sorted(p.name for p in (tmp_path / "outs").iterdir())
    assert len(names) == 6
    assert names == sorted(p.name for p in (tmp_path / "outs2").iterdir())
    for n in names:
        assert (tmp_path / "outs" / n).read_bytes() == (tmp_path / "outs2" / n).read_bytes()
