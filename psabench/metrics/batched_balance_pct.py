"""How evenly a batched launch splits its pairs over the kernel's warp
workers: the `launch` spans' `balance_pm` attribute (1000 x the mean
worker's pairs over the longest worker's, from the launch's plan), averaged
over the window's batched launches outside the profile and read as a
percentage.  A launch lasts as long as its longest worker: at 100 none
outlasts the mean.  A program whose launches carry no such attribute, or a
run whose batched sweeps ran no kernel, reads nothing."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "kernels"
MOVES = "pair_evals_per_s"
WORKLOADS = ("batch.long_rows", "batch.long_shared")


def read(ctx):
    launches = [s for r, spans in program_spans.joined(ctx)
                if not r.profiled for s in spans
                if s.name == "launch" and "balance_pm" in s.attrs]
    if not launches:
        return None
    return sum(s.attrs["balance_pm"] for s in launches) / (10.0 * len(launches))
