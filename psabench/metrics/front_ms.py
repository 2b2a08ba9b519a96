"""The engine's and the batch front's own time a request: the request span
less its children (upload, the device work or its launch, the fetch's wait,
host selection), averaged over the requests the profiler did not record.
It holds the checks, the encode, the buckets and every call between."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine and batch front"
MOVES = "request_ms_p95"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    if not ctx.spans:
        return None
    own = [s["request"] - sum(v for k, v in s.items() if k != "request")
           for s in ctx.spans]
    return 1e3 * sum(own) / len(own)
