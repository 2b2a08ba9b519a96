"""The batch entry: `psa_torch.models.batch.search_batch(queries,
backend=...)`, what `psa-torch --batch` and a library batch call run.

One request is one `search_batch` call: validation, buckets and the encode,
the uploads (`upload_rows`), the batched sweep and the epilogue
(`run_exact_batch`), the fetch's wait (`Fetch.wait`), and host selection
(`_host_select`).
"""

from __future__ import annotations

from psabench.spans import Target

SPANS = (
    Target("psa_torch.models.batch", "upload_rows", "upload"),
    Target("psa_torch.models.batch", "run_exact_batch", "launch"),
    Target("psa_torch.models.batch", "Fetch.wait", "fetch_wait"),
    Target("psa_torch.models.batch", "_host_select", "host_select"),
)


class Entry:
    def __init__(self, config: dict, device):
        import numpy as np

        from psa_torch.models import batch
        from psa_torch.utils.io import Query

        self._batch = batch
        self._query = Query
        self.weights = np.asarray(config["weights"], np.float64)
        self.is_max = config["mode"] == "maximum"
        self.backend = config["backend"]
        self.device = device

    def prepare(self, queries: list):
        """The call's arguments, made before the window: one `Query` a
        (seq1, seq2)."""
        return [self._query(self.weights, s1, s2, self.is_max)
                for s1, s2 in queries]

    def __call__(self, prepared) -> list:
        """[(offset, char_offset, sub_code, score) or None] per query, in
        order."""
        out = self._batch.search_batch(prepared, backend=self.backend,
                                       device=self.device)
        return [None if r is None else
                (r.offset, r.char_offset, r.sub_code, r.score) for r in out]
