"""A small registry of language-model specs (the counterpart of
``repro/configs/base.py``'s ``register`` / ``get_arch``).

The reference's ``ArchSpec`` families also carry dry-run cells and a
training set-up; the port's serving slice needs only the shapes, so a spec
here is the published config, its reduced CPU config and its source.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models.transformer import LMConfig

_REGISTRY: Dict[str, Callable[[], "LMSpec"]] = {}


@dataclasses.dataclass(frozen=True)
class LMSpec:
    arch_id: str
    cfg: LMConfig          # the published widths
    smoke_cfg: LMConfig    # a few narrow layers in float32, for the CPU
    source: str


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_arch(arch_id: str) -> LMSpec:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    return sorted(_REGISTRY)
