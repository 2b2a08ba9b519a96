"""Local multi-process launcher: `psa-torch-dist -np N [--port P] input.txt
[psa-torch flags...]`.

The reference launches its distributed run as `mpiexec -np 2 -machinefile
mf -map-by node ./bin` (Makefile:18-22).  This starts N copies of
`python -m psa_torch.utils.cli ... --distributed` joined through a Gloo
rendezvous on 127.0.0.1:P (rank 0 listens there); on several machines run
one `psa-torch --distributed` per process instead, or torchrun.  Every rank
is a fresh interpreter (none is forked from a process that has touched
CUDA); ranks share the machine's cards, rank r taking cuda:(r % cards).

Rank 0's stdout and stderr stream through; the other ranks' output is
spooled to a temporary file and replayed only when they fail.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env() -> dict:
    """The ranks' environment: Gloo names its endpoints by the host name,
    so where that name does not resolve the ranks keep to the loopback
    interface."""
    env = dict(os.environ)
    try:
        socket.gethostbyname(socket.gethostname())
    except OSError:
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="psa-torch-dist",
        description="launch an N-process distributed psa-torch search on "
                    "this machine (mpiexec -np N analog); every other "
                    "argument goes to psa-torch")
    p.add_argument("-np", "--num-processes", type=int, default=2,
                   help="process count (default 2, like the reference's "
                        "Makefile run target)")
    p.add_argument("--port", type=int, default=None,
                   help="rendezvous port on 127.0.0.1 (default: a free one)")
    return p


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args, rest = build_parser().parse_known_args(argv)
    n = args.num_processes
    if n < 1:
        print("error: -np must be at least 1", file=sys.stderr)
        return 2
    port = args.port or _free_port()
    common = [sys.executable, "-m", "psa_torch.utils.cli", *rest,
              "--distributed", "--coordinator", f"127.0.0.1:{port}",
              "--num-processes", str(n)]
    env = _child_env()
    procs, logs = [], []
    try:
        for i in range(n):
            cmd = common + ["--process-id", str(i)]
            if i == 0:
                procs.append(subprocess.Popen(cmd, env=env))
                logs.append(None)
            else:
                # a PIPE would fill and stall a rank that logs more than
                # the pipe holds
                f = tempfile.TemporaryFile(mode="w+")
                procs.append(subprocess.Popen(cmd, stdout=f, stderr=f,
                                              env=env))
                logs.append(f)
        rc = procs[0].wait()
        for i, p in enumerate(procs[1:], start=1):
            p.wait()
            if p.returncode not in (0, rc):
                logs[i].seek(0)
                print(f"[psa-torch-dist] rank {i} exited {p.returncode}:\n"
                      f"{logs[i].read()}", file=sys.stderr)
                rc = rc or p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            if f is not None:
                f.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
