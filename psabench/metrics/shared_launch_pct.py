"""The share of the batched launches that ran the shared-Seq1 kernel
(`sweep_batched_kernel<true>`): the `launch` spans' `shared` attribute,
over the window's requests outside the profile.  The cell exists to
measure that kernel; were the batch front's dispatch rule to stop finding
the one Seq1 that a call's queries share, this would read below 100 and
the cell would be timing the other kernel."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "kernels"
MOVES = "pair_evals_per_s"
WORKLOADS = ("batch.long_shared",)


def read(ctx):
    launches = [s for r, spans in program_spans.joined(ctx)
                if not r.profiled for s in spans
                if s.name == "launch" and "shared" in s.attrs]
    if not launches:
        return None
    return 100.0 * sum(s.attrs["shared"] for s in launches) / len(launches)
