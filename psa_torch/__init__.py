"""psa_torch — the mutant-alignment search engine on PyTorch and CUDA.

The PyTorch/CUDA counterpart of `psa_tpu`, module for module: the same
winner tuple (offset, char_offset, substitute, score) and the same output
bytes for every query, one at a time (models/search.py), in batches
(models/batch.search_batch) or served from stdin or TCP clients
(utils/server.py, `psa-torch --serve`).  The offset sweeps run in CUDA kernels written
for Hopper (csrc/sweep.cu for one query, csrc/sweep_batched.cu for a
batch); everything around them is plain torch on the card and numpy on the
host.  The package imports neither JAX nor `psa_tpu`.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); with no GPU present they raise instead of running on the
host.
"""

from psa_torch.core.alphabet import decode, encode
from psa_torch.core.result import NoMutationFound, SearchResult
from psa_torch.core.tables import ScoringTables, build_tables
from psa_torch.models.search import AlignmentSearchEngine, search
from psa_torch.utils.io import Query


def search_batch(queries, backend: str = "torch",
                 strict_alphabet: bool = True, device=None, mesh=None):
    """Lazy re-export of models.batch.search_batch (the batch module loads
    only when a batch is searched)."""
    from psa_torch.models.batch import search_batch as _sb

    return _sb(queries, backend=backend, strict_alphabet=strict_alphabet,
               device=device, mesh=mesh)


__all__ = [
    "encode",
    "decode",
    "ScoringTables",
    "build_tables",
    "SearchResult",
    "NoMutationFound",
    "AlignmentSearchEngine",
    "search",
    "search_batch",
    "Query",
]
