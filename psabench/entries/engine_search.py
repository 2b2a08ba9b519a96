"""The single-query entry: `AlignmentSearchEngine(...).search(seq1, seq2)`,
what the CLI and a library user call for one query.

One request is one `search` call: checks and encode, the upload of both
sequences (`upload_codes`), the sweep and the epilogue (`run_exact`), the
fetch, and host selection (`host_select`).
"""

from __future__ import annotations

from psabench.spans import Target

# the layer boundaries a traced run times (spans.py); `run_exact` ends
# synchronised, so the wait for the sweep that the fetch would hold lands in
# "device"
SPANS = (
    Target("psa_torch.models.batch", "upload_codes", "upload"),
    Target("psa_torch.models.batch", "run_exact", "device", sync=True),
    Target("psa_torch.models.batch", "host_select", "host_select"),
)


class Entry:
    def __init__(self, config: dict, device):
        from psa_torch.core.result import NoMutationFound
        from psa_torch.models.search import AlignmentSearchEngine

        self._none = NoMutationFound
        self.engine = AlignmentSearchEngine(
            config["weights"], config["mode"] == "maximum",
            backend=config["backend"], device=device)

    def prepare(self, queries: list):
        """The call's arguments, made before the window: (seq1, seq2)."""
        if len(queries) != 1:
            raise ValueError("engine_search takes one query a call")
        return queries[0]

    def __call__(self, prepared) -> list:
        """[(offset, char_offset, sub_code, score) or None] of the one
        query."""
        try:
            r = self.engine.search(*prepared)
        except self._none:
            return [None]
        return [(r.offset, r.char_offset, r.sub_code, r.score)]
