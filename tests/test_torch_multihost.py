"""psa_torch.parallel.multihost against the JAX package's multihost module:
the single-process paths of run_distributed_search and
run_distributed_batch (byte-equal outputs), the partition, the primary's
read and its errors, and the group's exchanges in two real processes
joined by Gloo on the CPU.  Inputs are generated; no file outside the test
directory is read."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from psa_tpu.parallel import multihost as jmh
from psa_tpu.utils import cli as jax_cli

from psa_torch.core.alphabet import encode
from psa_torch.parallel import multihost
from psa_torch.utils import cli
from psa_torch.utils.generator import random_sequences, write_input_file
from psa_torch.utils.io import Query

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_cases(path: Path) -> None:
    recs = []
    for seed, (n1, n2, mode) in enumerate([(400, 60, "minimum"), (400, 60, "maximum"),
                                           (700, 120, "minimum"), (300, 50, "maximum")]):
        s1, s2 = random_sequences(n1, n2, seed=60 + seed)
        recs.append(f"1 3 4 2\n{s1}\n{s2}\n{mode}")
    s1, s2 = random_sequences(300, 50, seed=99)
    recs.append(f"2 1 5 0.5\n{s1[:100]}xyzé{s1[104:]}\n{s2}\nminimum")
    recs.append("1 3 4 2\n" + "#" * 200 + "\n" + "!" * 20 + "\nmaximum")
    path.write_text("\n".join(recs), encoding="utf-8")


def test_initialize_single_process_is_a_noop():
    multihost.initialize()
    multihost.initialize(None, 1, 0, force=False)
    assert multihost.is_primary()
    assert multihost.process_layout() == (1, 0)
    q = Query(np.array([1.0, 3.0, 4.0, 2.0]), "ABCDEFG", "ABC", False)
    assert multihost.broadcast_query(q) is q
    assert multihost.broadcast_cases([q]) == [q]


def test_initialize_force_without_a_cluster_raises(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError):
        multihost.initialize(force=True)
    with pytest.raises(ValueError):
        multihost.initialize("127.0.0.1:1", 2, None)


def test_group_timeout_is_finite(monkeypatch):
    monkeypatch.delenv("PSA_DIST_TIMEOUT", raising=False)
    assert multihost._timeout().total_seconds() == multihost.DEFAULT_TIMEOUT_S
    assert multihost.DEFAULT_TIMEOUT_S < 30 * 60
    monkeypatch.setenv("PSA_DIST_TIMEOUT", "7.5")
    assert multihost._timeout().total_seconds() == 7.5


@pytest.mark.parametrize("n", [1, 5, 7, 1024])
@pytest.mark.parametrize("nproc", [1, 2, 3, 8])
def test_partition_matches_jax(n, nproc):
    blocks = [multihost._partition(n, nproc, p) for p in range(nproc)]
    assert blocks == [jmh._partition(n, nproc, p) for p in range(nproc)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


def test_rank_device(monkeypatch):
    assert multihost.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        multihost.rank_device()


def test_read_on_primary_errors(tmp_path):
    from psa_torch.utils.io import read_input

    with pytest.raises(FileNotFoundError):
        multihost._read_on_primary(read_input, str(tmp_path / "none.txt"), False,
                                   lambda q: True)
    bad = tmp_path / "bad.txt"
    bad.write_text("1 3 4\nABC\n")
    with pytest.raises(ValueError, match="bad input file"):
        multihost._read_on_primary(read_input, str(bad), False, lambda q: True)
    lenient = tmp_path / "lenient.txt"
    lenient.write_text("1 3 4 2\nAB#DEFG\nABC\nminimum\n")
    with pytest.raises(ValueError, match="A-Z"):
        multihost._read_on_primary(read_input, str(lenient), False, lambda q: False)
    assert multihost._read_on_primary(read_input, str(lenient), True,
                                      lambda q: False).seq1 == "AB#DEFG"


@pytest.mark.parametrize("is_max,seed", [(False, 1), (True, 2)])
def test_run_distributed_search_single_process_matches_jax(tmp_path, is_max, seed):
    s1, s2 = random_sequences(1500, 300, seed=seed)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), [2.0, 1.0, 0.5, 3.0], s1, s2, is_max)
    out, ref = tmp_path / "out.txt", tmp_path / "ref.txt"
    assert multihost.run_distributed_search(str(inp), str(out),
                                            mesh=["cpu"] * 4) == 0
    assert jmh.run_distributed_search(str(inp), str(ref), backend_kernel="xla") == 0
    assert out.read_bytes() == ref.read_bytes()
    one = tmp_path / "one.txt"
    assert cli.main([str(inp), "-o", str(one), "--device", "cpu", "--quiet"]) == 0
    assert out.read_bytes() == one.read_bytes()


def test_run_distributed_search_no_mutation(tmp_path):
    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2\n" + "#" * 300 + "\n" + "#" * 40 + "\nmaximum\n")
    out, ref = tmp_path / "out.txt", tmp_path / "ref.txt"
    assert multihost.run_distributed_search(str(inp), str(out), lenient=True,
                                            mesh=["cpu"]) == 1
    assert jmh.run_distributed_search(str(inp), str(ref), backend_kernel="xla",
                                      lenient=True) == 1
    assert out.read_bytes() == ref.read_bytes()
    with pytest.raises(ValueError):
        multihost.run_distributed_search(str(inp), str(out), mesh=["cpu"])


@pytest.mark.parametrize("shard_local", [False, True])
def test_run_distributed_batch_single_process_matches_jax(tmp_path, capsys, shard_local):
    inp = tmp_path / "cases.txt"
    write_cases(inp)
    refdir = tmp_path / "ref"
    assert jax_cli.main([str(inp), "-o", str(refdir), "--batch", "--lenient",
                         "--backend", "numpy", "--quiet"]) == 1
    jdir = tmp_path / "jax"
    assert jmh.run_distributed_batch(str(inp), str(jdir), backend="native",
                                     lenient=True, quiet=True) == 1
    capsys.readouterr()
    outdir = tmp_path / "outs"
    rc = multihost.run_distributed_batch(str(inp), str(outdir), lenient=True,
                                         quiet=True, json_out=True,
                                         shard_local=shard_local,
                                         device=torch.device("cpu"))
    assert rc == 1
    cap = capsys.readouterr()
    objs = [json.loads(ln) for ln in cap.out.strip().splitlines()]
    assert [o["case"] for o in objs] == list(range(6))
    assert [o["mutation_found"] for o in objs] == [True] * 5 + [False]
    assert cap.err == ""
    names = sorted(p.name for p in refdir.iterdir())
    assert names == sorted(p.name for p in outdir.iterdir())
    for name in names:
        assert (outdir / name).read_bytes() == (refdir / name).read_bytes() \
            == (jdir / name).read_bytes()


def test_two_processes_exchange_queries_and_cases(tmp_path):
    """Two real ranks: rank 1 receives the whole case list (out-of-alphabet
    bytes and all) and the first query by broadcast, and the all_gather
    returns every rank's row in rank order."""
    inp = tmp_path / "cases.txt"
    write_cases(inp)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), "2", str(port),
                               str(inp) if r == 0 else str(tmp_path / "never.txt")],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=120)
            assert p.returncode == 0, e
            outs.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    from psa_torch.utils.io import read_cases

    want = [[list(map(float, q.weights)), q.seq1, q.seq2, q.is_max]
            for q in read_cases(str(inp))]
    assert "xyzé" in want[4][1]
    q0 = read_cases(str(inp))[0]
    for r, got in enumerate(outs):
        assert got["rank"] == r and got["primary"] == (r == 0)
        assert got["cases"] == want
        assert got["query"] == [list(map(float, q0.weights)),
                                encode(q0.seq1).tolist(), encode(q0.seq2).tolist(),
                                q0.is_max]
        assert got["gathered"] == [0, 1]


def test_cli_paths_need_the_card_unless_cpu(tmp_path, monkeypatch, capsys):
    """--sharded and --distributed resolve the card first: without one
    they exit 2 and never run on the host; --device cpu runs them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s1, s2 = random_sequences(500, 50, seed=3)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), [1.0, 3.0, 4.0, 2.0], s1, s2, False)
    cases = tmp_path / "cases.txt"
    write_cases(cases)
    out = tmp_path / "o.txt"
    for argv in ([str(inp), "--sharded"], [str(inp), "--distributed"],
                 [str(cases), "--batch", "--sharded", "--lenient"],
                 [str(cases), "--batch", "--sharded", "--backend", "native"],
                 [str(cases), "--batch", "--distributed"],
                 [str(inp), "--sharded", "--backend", "numpy"]):
        assert cli.main([*argv, "-o", str(out), "--quiet"]) == 2, argv
        assert not out.exists()
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main([str(inp), "--sharded", "--device", "cpu", "-o", str(out),
                     "--quiet"]) == 0
    one = tmp_path / "one.txt"
    assert cli.main([str(inp), "--device", "cpu", "-o", str(one), "--quiet"]) == 0
    assert out.read_bytes() == one.read_bytes()


def test_cli_sharded_host_backend_warns_and_runs_on_the_mesh(tmp_path, capsys):
    s1, s2 = random_sequences(800, 90, seed=4)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), [1.0, 3.0, 4.0, 2.0], s1, s2, True)
    out, ref = tmp_path / "o.txt", tmp_path / "r.txt"
    assert cli.main([str(inp), "--sharded", "--backend", "numpy", "--device", "cpu",
                     "-o", str(out), "--quiet"]) == 0
    assert "has no sharded path; using the torch kernel" in capsys.readouterr().err
    assert jax_cli.main([str(inp), "--backend", "numpy", "-o", str(ref), "--quiet"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert cli.main([str(inp), "--sharded", "--backend", "hybrid", "-o", str(out)]) == 2
    assert cli.main([str(inp), "--distributed", "--device-share", "50",
                     "-o", str(out)]) == 2


def test_cli_sharded_batch_and_serve_on_the_cpu_mesh(tmp_path, monkeypatch, capsys):
    cases = tmp_path / "cases.txt"
    write_cases(cases)
    a, b = tmp_path / "a", tmp_path / "b"
    assert cli.main([str(cases), "--batch", "--sharded", "--lenient", "--device", "cpu",
                     "-o", str(a), "--quiet"]) == 1
    assert cli.main([str(cases), "--batch", "--lenient", "--device", "cpu",
                     "-o", str(b), "--quiet"]) == 1
    for f in sorted(b.iterdir()):
        assert (a / f.name).read_bytes() == f.read_bytes()
    import io

    lines = "".join(f"1 3 4 2 {s1} {s2} minimum\n" for s1, s2 in
                    (random_sequences(300, 40, seed=s) for s in range(5)))
    replies = []
    for extra in (["--sharded"], []):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        capsys.readouterr()
        assert cli.main(["--serve", "--quiet", "--device", "cpu", *extra]) == 0
        replies.append(capsys.readouterr().out)
    assert replies[0] == replies[1] and len(replies[0].splitlines()) == 5
