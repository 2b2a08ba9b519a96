"""The serving entry: `psa-torch --serve --listen HOST:PORT --warmup FILE
--warmup-sizes 1,2,4,8`, the long-lived TCP server, built from the argv
the configuration states through the CLI's own parser and functions, in
the order `cli._main_serve` calls them, set-up apart from serving.

Set-up (`setup`, in the run's set-up): `build_parser`, the device
(`_batch_device`, `_batch_mesh`), the finishing thread (`Finisher`) and
the warm-up on the pool's own lines (`_serve_warmup`).  The window
(`serve`, on the main thread: the server installs signal handlers):
`server.serve_tcp` until a SIGTERM, which finishes the chunks in flight.
The traffic kind (traffic/tcp_clients.py) sends the requests and stops
the server.

A request is one query line and its reply; the serve loop's own spans
(`psa_torch.utils.server`) time its layers, so the harness wraps nothing.
"""

from __future__ import annotations

import os
import tempfile

SPANS = ()


class Entry:
    def __init__(self, config: dict, device):
        self.config = config
        self.device = device
        self._run = None

    def prepare(self, queries: list) -> str:
        """A request's line, made before the window: the configuration's
        weights, Seq1, Seq2 and mode, newline-terminated."""
        if len(queries) != 1:
            raise ValueError("tcp_serve takes one query a request")
        (s1, s2), = queries
        w = " ".join("%g" % x for x in self.config["weights"])
        return f"{w} {s1} {s2} {self.config['mode']}\n"

    def argv(self, port: int, warmup: str) -> list:
        """The command line, from the configuration's `argv`; on a CPU
        device (the tests) with `--device cpu` added."""
        out = [a.format(port=port, warmup=warmup)
               for a in self.config["argv"]]
        return out + (["--device", "cpu"] if self.device.type == "cpu"
                      else [])

    def setup(self, lines: list, port: int) -> None:
        """The server's set-up, warmed on `lines`, to listen on `port`."""
        from psa_torch.utils import cli
        from psa_torch.utils.server import Finisher

        fd, path = tempfile.mkstemp(prefix="psabench-warmup-",
                                    suffix=".txt")
        try:
            with os.fdopen(fd, "w") as f:
                f.writelines(lines)
            args = cli.build_parser().parse_args(self.argv(port, path))
            err = cli._fold_device_share(args)
            if err is not None:
                raise ValueError(err)
            device, mesh = cli._batch_device(args), cli._batch_mesh(args)
            fin = Finisher()
            rc = cli._serve_warmup(args, device, mesh, fin)
        finally:
            os.unlink(path)
        if rc:
            fin.close()
            raise RuntimeError(f"the server's warm-up exited {rc}")
        self._run = (args, device, mesh, fin)

    def serve(self) -> int:
        """The server on this thread, until it is stopped -> its exit
        code."""
        from psa_torch.utils.server import serve_tcp

        args, device, mesh, fin = self._run
        return serve_tcp(args.listen, backend=args.backend,
                         lenient=args.lenient, json_out=args.json,
                         device=device, max_batch=args.serve_batch,
                         quiet=args.quiet, mesh=mesh, finisher=fin)
