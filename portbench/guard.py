"""The benchmark measures the PyTorch port only: no JAX, and not the JAX
package the port was made from.  Module names are compared by their top
level (the part before the first dot), whole: ``repro_torch`` is the
port, ``repro`` is not."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


__all__ = ["FORBIDDEN", "forbidden_loaded"]
