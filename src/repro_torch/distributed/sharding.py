"""Logical-axis rules: which mesh dimension each logical axis shards over
(the port of ``repro/distributed/sharding.py``).

``DEFAULT_RULES`` is a copy of the reference's table (data, not code).  The
graph side reads two of its entries: ``edges -> ("pod", "data")`` (the
edge partition of the distributed engine and the serving ring's slot
chunks) and ``queries -> "model"`` (the rows of a multi-source batch).

``logical_spec`` resolves a tensor's logical axes to mesh axes as the
reference does (an axis absent from the mesh is dropped, one whose mesh
size does not divide the dimension is replicated) and returns a tuple of
entries, equal to the reference's ``PartitionSpec``.  A mesh is a
``DeviceMesh`` (its ``mesh_dim_names`` and shape) or a mapping of axis
name to size.  ``constrain`` and ``gather_fsdp`` are the identity outside
a mesh, as in the reference; under an active mesh (``use_mesh``) they raise
``NotImplementedError``: sharded training is ROADMAP Queue 1 item 16, and
so are ``named_sharding`` and ``spec_tree_sharding``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]

# default logical -> mesh-axis rules (production mesh: pod/data/model)
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",          # decode-cache sequence (flash-decoding combine)
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "moe_capacity": "data",
    "moe_groups": ("pod", "data"),
    "fsdp": "data",             # ZeRO-3 parameter dimension
    "layers": None,
    "edges": ("pod", "data"),   # graph engine: edge partitioning
    "queries": "model",         # graph engine: multi-source query batches
    "vertices": None,
    "feat": "model",            # GNN feature dim
    "rows": "model",            # embedding-table rows
    "candidates": "model",      # recsys retrieval candidates
    "interests": None,
}



@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: Dict[str, MeshAxes]

    def resolve(self, axis: Optional[str]) -> MeshAxes:
        if axis is None:
            return None
        if axis not in self.rules:
            raise KeyError(f"unknown logical axis {axis!r}")
        return self.rules[axis]


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: AxisRules = AxisRules(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = AxisRules({**DEFAULT_RULES, **rules})
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def _mesh_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _axis_size(sizes: Dict[str, int], axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= sizes.get(a, 1)
    return size


def _mesh_axes_present(sizes: Dict[str, int], axes: MeshAxes) -> MeshAxes:
    """Drop mesh axes that do not exist on this mesh (e.g. 'pod' single-pod)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in sizes else None
    kept = tuple(a for a in axes if a in sizes)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def logical_spec(dim_sizes: Sequence[Optional[int]], logical_axes: Sequence[Optional[str]],
                 mesh=None, rules: Optional[AxisRules] = None) -> Tuple[MeshAxes, ...]:
    """The mesh axes of each dimension; any axis whose mesh size does not
    divide the dimension is replicated instead."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules or _CTX.rules
    sizes = _mesh_sizes(mesh) if mesh is not None else None
    specs = []
    for size, name in zip(dim_sizes, logical_axes):
        axes = rules.resolve(name)
        if sizes is not None:
            axes = _mesh_axes_present(sizes, axes)
            if axes is not None and size is not None and size % _axis_size(sizes, axes):
                axes = None
        specs.append(axes)
    return tuple(specs)


def _refuse_under_mesh(what: str):
    raise NotImplementedError(
        f"{what} under an active mesh: sharded training is not in the port yet "
        f"(ROADMAP Queue 1 item 16)")


def constrain(x, *logical_axes: Optional[str]):
    """A sharding constraint by logical names; the identity with no mesh."""
    if _CTX.mesh is None:
        return x
    _refuse_under_mesh("constrain")


def gather_fsdp(x, *logical_axes: Optional[str]):
    """The ZeRO-3 weight gather at use time; the identity with no mesh."""
    if _CTX.mesh is None:
        return x
    _refuse_under_mesh("gather_fsdp")


__all__ = ["DEFAULT_RULES", "MeshAxes", "AxisRules", "use_mesh", "current_mesh",
           "logical_spec", "constrain", "gather_fsdp"]
