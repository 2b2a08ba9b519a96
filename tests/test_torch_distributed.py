"""Real multi-process runs of the port's CLI on the CPU: ranks joined by a
Gloo group through 127.0.0.1 (`psa-torch --distributed`, and the
`psa-torch-dist` launcher), against one process's `psa-torch --device cpu`
and the JAX package's `psa --backend numpy`, byte for byte.  Every process
runs under its own communicate(timeout=...), so a stuck rendezvous fails
the test instead of hanging the suite.  Inputs are generated."""

import socket
import subprocess
import sys
from pathlib import Path

import pytest

from psa_tpu.utils import cli as jax_cli

from psa_torch.utils import cli
from psa_torch.utils.generator import random_sequences, write_input_file

ROOT = Path(__file__).resolve().parent.parent
CLI = [sys.executable, "-m", "psa_torch.utils.cli"]
LAUNCHER = [sys.executable, "-m", "psa_torch.utils.launcher"]
TIMEOUT = 150


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_all(cmds, timeout: int = TIMEOUT):
    """Start every command, then wait for each under its own timeout ->
    [(returncode, stdout, stderr)]; a process still alive is killed."""
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def ranks(n: int, argv_of_rank):
    base = [*CLI, "--distributed", "--device", "cpu", "--coordinator",
            f"127.0.0.1:{free_port()}", "--num-processes", str(n)]
    return run_all([base + ["--process-id", str(r), *argv_of_rank(r)]
                    for r in range(n)])


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    d = tmp_path_factory.mktemp("single")
    s1, s2 = random_sequences(3000, 400, seed=21)
    inp = d / "input.txt"
    write_input_file(str(inp), [1.0, 3.0, 4.0, 2.0], s1, s2, False)
    one, ref = d / "one.txt", d / "ref.txt"
    assert cli.main([str(inp), "--device", "cpu", "-o", str(one), "--quiet"]) == 0
    assert jax_cli.main([str(inp), "--backend", "numpy", "-o", str(ref), "--quiet"]) == 0
    assert one.read_bytes() == ref.read_bytes()
    return inp, one.read_bytes()


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = tmp_path_factory.mktemp("cases")
    recs = []
    for seed, (n1, n2, mode) in enumerate([(400, 60, "minimum"), (400, 60, "maximum"),
                                           (700, 120, "minimum"), (300, 50, "minimum"),
                                           (300, 50, "maximum")]):
        s1, s2 = random_sequences(n1, n2, seed=60 + seed)
        recs.append(f"1 3 4 2\n{s1}\n{s2}\n{mode}")
    s1, s2 = random_sequences(300, 50, seed=99)
    # out-of-alphabet bytes: the case broadcast must carry them, not '?'
    recs.append(f"1 3 4 2\n{s1[:100]}xyz{s1[103:]}\n{s2}\nminimum")
    inp = d / "cases.txt"
    inp.write_text("\n".join(recs))
    one, ref = d / "one", d / "ref"
    assert cli.main([str(inp), "--batch", "--lenient", "--device", "cpu",
                     "-o", str(one), "--quiet"]) == 0
    assert jax_cli.main([str(inp), "--batch", "--lenient", "--backend", "numpy",
                         "-o", str(ref), "--quiet"]) == 0
    files = {f.name: f.read_bytes() for f in sorted(one.glob("out_*.txt"))}
    assert files == {f.name: f.read_bytes() for f in sorted(ref.glob("out_*.txt"))}
    return inp, files


def test_two_process_cli(tmp_path, single):
    """Rank 1 is given a path that does not exist: it can only answer
    through the broadcast.  Rank 0 writes and prints the trailer."""
    inp, want = single
    out = tmp_path / "out.txt"
    outs = ranks(2, lambda r: [str(inp) if r == 0 else "/nonexistent/never-read.txt",
                               "-o", str(out)])
    assert [rc for rc, _, _ in outs] == [0, 0], outs
    assert "total time:" in outs[0][1] and "total time:" not in outs[1][1]
    for r, (_, _, err) in enumerate(outs):
        assert f"[dist] rank {r} of 2: device cpu, group backend gloo" in err
    assert out.read_bytes() == want


@pytest.mark.parametrize("sharded", [False, True])
def test_two_process_batch(tmp_path, cases, sharded):
    """--distributed --batch (with --sharded: each rank shards its block
    over its own mesh): contiguous case blocks per rank, the gathered
    outputs byte-equal to one process's."""
    inp, want = cases
    outdir = tmp_path / "outs"
    extra = ["--sharded"] if sharded else []
    outs = ranks(2, lambda r: [str(inp) if r == 0 else "/nonexistent/never-read.txt",
                               "--batch", "--lenient", "--quiet", "-o", str(outdir),
                               *extra])
    assert [rc for rc, _, _ in outs] == [0, 0], outs
    assert {f.name: f.read_bytes() for f in sorted(outdir.glob("out_*.txt"))} == want


def test_two_process_bad_input_fails_every_rank(tmp_path):
    out = tmp_path / "out.txt"
    outs = ranks(2, lambda r: ["/nonexistent/input.txt", "-o", str(out)])
    assert [rc for rc, _, _ in outs] == [2, 2], outs
    assert "cannot open input file" in outs[0][2]
    assert not out.exists()


def test_two_process_no_mutation(tmp_path):
    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2\n" + "#" * 300 + "\n" + "#" * 40 + "\nmaximum\n")
    out, one = tmp_path / "out.txt", tmp_path / "one.txt"
    outs = ranks(2, lambda r: [str(inp), "--lenient", "-o", str(out), "--quiet"])
    assert [rc for rc, _, _ in outs] == [1, 1], outs
    assert cli.main([str(inp), "--lenient", "--device", "cpu", "-o", str(one),
                     "--quiet"]) == 1
    assert out.read_bytes() == one.read_bytes()


def test_two_process_env_rendezvous(tmp_path, single):
    """--distributed alone reads torchrun's environment (env://): RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK."""
    import os

    inp, want = single
    out = tmp_path / "out.txt"
    port = str(free_port())
    procs = []
    try:
        for r in range(2):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [*CLI, "--distributed", "--device", "cpu", str(inp), "-o", str(out),
                 "--quiet"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        rcs = []
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            rcs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [rc for rc, _ in rcs] == [0, 0], rcs
    assert out.read_bytes() == want


def test_launcher_two_processes(tmp_path, single, cases):
    inp, want = single
    out = tmp_path / "out.txt"
    (rc, _, err), = run_all([[*LAUNCHER, "-np", "2", str(inp), "--device", "cpu",
                              "-o", str(out), "--quiet"]])
    assert rc == 0, err
    assert out.read_bytes() == want
    cinp, cwant = cases
    outdir = tmp_path / "outs"
    (rc, _, err), = run_all([[*LAUNCHER, "-np", "2", str(cinp), "--batch", "--lenient",
                              "--device", "cpu", "-o", str(outdir), "--quiet"]])
    assert rc == 0, err
    assert {f.name: f.read_bytes() for f in sorted(outdir.glob("out_*.txt"))} == cwant


def test_launcher_bad_input_exits_2(tmp_path):
    (rc, _, err), = run_all([[*LAUNCHER, "-np", "2", str(tmp_path / "missing.txt"),
                              "--device", "cpu", "-o", str(tmp_path / "o.txt")]])
    assert rc == 2
    assert "cannot open input file" in err


@pytest.mark.slow
def test_launcher_four_processes(tmp_path, single, cases):
    """Four ranks: the case blocks of 6 cases over 4 ranks (1, 1, 1, 3) and
    a query's offsets over 4 shards."""
    inp, want = single
    out = tmp_path / "out.txt"
    (rc, _, err), = run_all([[*LAUNCHER, "-np", "4", str(inp), "--device", "cpu",
                              "-o", str(out), "--quiet"]], timeout=300)
    assert rc == 0, err
    assert out.read_bytes() == want
    cinp, cwant = cases
    outdir = tmp_path / "outs"
    (rc, _, err), = run_all([[*LAUNCHER, "-np", "4", str(cinp), "--batch", "--lenient",
                              "--sharded", "--device", "cpu", "-o", str(outdir),
                              "--quiet"]], timeout=300)
    assert rc == 0, err
    assert {f.name: f.read_bytes() for f in sorted(outdir.glob("out_*.txt"))} == cwant
