"""Collectives over one named dimension of a device mesh.

The JAX package names a mesh axis inside ``shard_map`` and reduces over it
with ``pmin`` / ``pmax`` / ``psum``, gathers with ``all_gather`` and
replicates a sharded result with ``with_sharding_constraint(..., P())``.
Here every rank is its own process, a mesh dimension resolves to the
process group of the ranks that share this rank's other coordinates
(:class:`MeshAxis`), and those operations become ``all_reduce`` and
``all_gather`` over that group:

  * :func:`all_reduce` with ``"min"`` / ``"max"`` / ``"sum"`` (in place);
  * :func:`all_gather`: the ranks' tensors concatenated along dim 0 in
    mesh-coordinate order, the torch form of gathering a row-sharded
    result back to every rank.

The backend follows the device: NCCL for CUDA tensors, gloo for CPU ones.
A CUDA tensor offered to a group that is not NCCL raises; nothing goes
through the host on the way.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

_OPS = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
        "sum": dist.ReduceOp.SUM}
# one gather into one output tensor (no concatenation after it); the name
# changed across torch versions
_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class MeshAxis(NamedTuple):
    """One mesh dimension as this rank sees it."""

    name: str                # the mesh dimension's name ("data", "model")
    group: Any               # process group of the ranks along it
    size: int                # ranks along the dimension
    index: int               # this rank's coordinate along it
    backend: str             # "nccl" | "gloo"


def mesh_axis(mesh, name: str) -> MeshAxis:
    """The :class:`MeshAxis` of ``mesh``'s dimension ``name``."""
    group = mesh.get_group(name)
    return MeshAxis(name, group, int(mesh.size(mesh.mesh_dim_names.index(name))),
                    int(mesh.get_local_rank(name)), str(dist.get_backend(group)))


def world_axis() -> MeshAxis:
    """Every rank of the default process group as one axis."""
    return MeshAxis("world", dist.group.WORLD, dist.get_world_size(),
                    dist.get_rank(), str(dist.get_backend()))


def _check(t: torch.Tensor, axis: MeshAxis) -> None:
    if t.is_cuda and axis.backend != "nccl":
        raise ValueError(
            f"a CUDA tensor needs an NCCL group; mesh dimension {axis.name!r} "
            f"runs on {axis.backend!r}")


def all_reduce(t: torch.Tensor, op: str, axis: MeshAxis) -> torch.Tensor:
    """Reduce ``t`` in place with ``op`` (min | max | sum) across the ranks
    along ``axis``; returns ``t``.  Booleans travel as uint8 (min is AND,
    max is OR)."""
    _check(t, axis)
    if t.dtype == torch.bool:
        wire = t.to(torch.uint8)
        dist.all_reduce(wire, op=_OPS[op], group=axis.group)
        return t.copy_(wire.bool())
    dist.all_reduce(t, op=_OPS[op], group=axis.group)
    return t


def all_gather(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) concatenated along dim 0 in
    coordinate order along ``axis`` (booleans travel as uint8)."""
    _check(t, axis)
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    out = wire.new_empty((axis.size * wire.shape[0],) + tuple(wire.shape[1:]))
    _gather_single(out, wire, group=axis.group)
    return out.bool() if t.dtype == torch.bool else out


__all__ = ["MeshAxis", "mesh_axis", "world_axis", "all_reduce", "all_gather"]
