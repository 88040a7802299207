"""The import guard: the benchmark measures the port, and nothing of a run may
load JAX or the JAX package. Names are compared whole at their top level
(the part before the first dot), so `satlas_sr_tpu_torch` passes where
`satlas_sr_tpu` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "satlas_sr_tpu"})


def forbidden(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
