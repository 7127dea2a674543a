"""Config substrate: shape cells and the architecture registry (the port of
``repro/configs/base.py``; the families are in ``families.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Callable[[], Any]] = {}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (architecture x input-shape) cell."""

    name: str
    kind: str                  # train | prefill | decode | serve | retrieval | analytics
    meta: Dict[str, Any]
    skip: Optional[str] = None  # reason when the cell is defined-but-skipped


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_arch(arch_id: str):
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    return sorted(_REGISTRY)
