"""The encode's host milliseconds a request: the program's `encode` spans
(the engine's two `encode` calls and int32 casts; the batch front's
`plan_bucket`, both `encode_batch_padded` calls and the offset and length
arrays), averaged over the requests the profiler did not record."""

from psabench import program_spans

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine and batch front"
MOVES = "request_ms_p95"
WORKLOADS = ("single.long_seq2", "batch.long_rows")


def read(ctx):
    return program_spans.mean_ms(ctx, "encode")
