"""Set-up: seconds from the process's start (the harness's first line) to the
window's start: imports, the CUDA context, the kernel library (built by nvcc
only in a checkout's first run), the inputs and the warm-up calls."""

KIND = "end_to_end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
