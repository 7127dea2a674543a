"""Config substrate: shape cells, the interface of an architecture family
and the architecture registry (the port of ``repro/configs/base.py``; the
families are in ``families.py`` and ``kairos.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Callable[[], "ArchSpec"]] = {}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (architecture x input-shape) cell."""

    name: str
    kind: str                  # train | prefill | decode | serve | retrieval | analytics
    meta: Dict[str, Any]
    skip: Optional[str] = None  # reason when the cell is defined-but-skipped


class ArchSpec:
    """Interface every architecture family implements (see families.py)."""

    arch_id: str = ""
    family: str = ""
    source: str = ""
    cells: Dict[str, Cell] = {}

    def dry_program(self, cell_name: str, mesh):
        """(fn, args): the cell's step and its arguments for the dry run
        (``launch/dryrun.py``), every tensor a ``meta`` DTensor placed on
        ``mesh`` — the counterpart of the reference's ``lowerable``."""
        raise NotImplementedError

    def model_flops(self, cell_name: str) -> float:
        """The model FLOPs of one step of the cell."""
        raise NotImplementedError

    def smoke(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Run one reduced-config forward/train step on ``device`` (the
        first CUDA card unless given); returns metrics, among them finite
        outputs (asserted by the tests)."""
        raise NotImplementedError


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    return sorted(_REGISTRY)
