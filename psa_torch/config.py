"""Engine configuration.

The reference hard-codes its knobs as #defines (def.h:4-48).  The port keeps
only the knobs its single-query and batch paths read, under the JAX
package's names and environment overrides.
"""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class EngineConfig:
    # host selection: above this many near-tied offsets the re-score notes
    # its cost on stderr
    max_candidates: int = _env_int("PSA_MAX_CANDIDATES", 4096)

    # batch path: queries stream through the device in microbatches of at
    # most this many, so the host selection of one overlaps the device work
    # of the next (models/batch.batched_search_exact)
    micro_batch: int = _env_int("PSA_MICRO_BATCH", 1024)

    # defaults mirroring the reference CLI contract (def.h:20-21)
    default_input: str = "./input.txt"
    default_output: str = "./output.txt"


CONFIG = EngineConfig()
