"""Query-axis (and edge-axis) sharding for multi-tenant batch serving.

The port runs SPMD over processes: every rank calls the same entry points
with the same inputs, and a ``torch.distributed.device_mesh.DeviceMesh``
over the process group says which share of the work is this rank's.

  * :func:`query_mesh` — a 1-D mesh over the ``"queries"`` rule's mesh
    dimension (``"model"``); :func:`serve_mesh` the 2-D ``("data",
    "model")`` edge x query mesh, which at one edge shard is the 1-D mesh.
  * :func:`row_partition` — the pad-and-mask row layout: ``n_rows`` rows in
    ``n_shards`` contiguous chunks of ``cap = ceil(n / D)`` rows, the tail
    padded by REPEATING THE LAST REAL ROW, so every rank has at least one
    real row to solve and takes part in every collective.  Real row ``j``
    keeps global index ``j``.
  * :func:`replicate` / :func:`replicated_arrays` — the structures every
    rank needs whole, on the rank's device.  Every rank builds the same
    tensors from the same inputs, so placement moves nothing between ranks.

A mesh is built over the WHOLE process group: a mesh whose size differs
from the group's world size raises ``ValueError`` naming both numbers, as
does any mesh without an initialised process group.  The backend follows
the device (``cuda`` -> NCCL, ``cpu`` -> gloo; :func:`init_process_group`).
Meshes are cached per (device type, shape) and process group, so a serving
chain that names its mesh by shape gets the same mesh object every call.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hostcache import identity_cache
from repro_torch.distributed.sharding import DEFAULT_RULES

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_MESHES: dict = {}


def query_axis() -> str:
    """The mesh dimension the ``"queries"`` logical axis maps to."""
    ax = DEFAULT_RULES["queries"]
    if not isinstance(ax, str):
        raise TypeError(f"'queries' must map to ONE mesh axis, got {ax!r}")
    return ax


def edge_axis() -> str:
    """The mesh dimension the serving ring's EDGE axis shards over: the
    ``"edges"`` rule maps to ``("pod", "data")``; the serving mesh is
    single-host, so it uses the last of those, ``"data"``."""
    ax = DEFAULT_RULES["edges"]
    return ax[-1] if isinstance(ax, (tuple, list)) else ax


def backend_for(device) -> str:
    """The process-group backend a device's tensors need."""
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no collective backend for device type {kind!r}")
    return _BACKENDS[kind]


def init_process_group(device, *, init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> None:
    """Initialise the default process group with the backend ``device``
    needs.  Without ``init_method`` the group comes from the environment
    ``torchrun`` sets (``env://``); on a CUDA device the rank's card is
    ``LOCAL_RANK``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    kw = {}
    if world_size is not None:
        kw.update(world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend_for(device),
                            init_method=init_method or "env://", **kw)


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device=None):
    n = int(np.prod(shape))
    if not dist.is_initialized():
        raise ValueError(
            f"a mesh of shape {shape} needs {n} ranks but no process group "
            f"is initialised: start the ranks with torchrun (or "
            f"torch.multiprocessing) and call init_process_group first")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"a mesh of shape {shape} needs {n} ranks but the process group "
            f"has {world}")
    backend = str(dist.get_backend())
    kind = ("cuda" if backend == "nccl" else "cpu") if device is None else \
        torch.device(device).type
    # the dry run's fake group ("fake") stands in for any backend
    if backend != "fake" and backend_for(kind) != backend:
        raise ValueError(
            f"{kind} tensors need the {backend_for(kind)!r} backend but the "
            f"process group runs {backend!r}")
    world_group = dist.group.WORLD
    key = (kind, tuple(shape), tuple(names))
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is world_group:
        return hit[1]
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))
    _MESHES[key] = (world_group, mesh)
    return mesh


def make_mesh(shape, names, *, device=None):
    """A ``DeviceMesh`` of ``shape`` with dimension ``names`` over the whole
    process group (the distributed engine's ``("data", "model")`` meshes);
    ``device`` as in :func:`query_mesh`."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or min(shape, default=0) < 1:
        raise ValueError(f"bad mesh shape {shape} for dimensions {names}")
    return _mesh(shape, names, device)


def query_mesh(n_devices: Optional[int] = None, *, device=None):
    """A one-dimension mesh over the query axis, of every rank by default.
    ``device`` (or its type) picks the mesh's device type; by default the
    process group's backend decides."""
    if n_devices is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    else:
        n = int(n_devices)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    return _mesh((n,), (query_axis(),), device)


def serve_mesh(edge_shards: int, query_shards: int, *, device=None):
    """The 2-D ``(edge_shards, query_shards)`` serving mesh: dimension
    ``"data"`` shards the ring view's slot axis, ``"model"`` the batch's
    row axis.  ``serve_mesh(1, D)`` is the 1-D :func:`query_mesh`."""
    e, d = int(edge_shards), int(query_shards)
    if e < 1 or d < 1:
        raise ValueError(f"mesh shape must be >= (1, 1), got ({e}, {d})")
    if e == 1:
        return query_mesh(d, device=device)
    return _mesh((e, d), (edge_axis(), query_axis()), device)


def mesh_shape(mesh) -> Tuple[int, int]:
    """A serving mesh's ``(E, D)``: the row axis is the LAST dimension, the
    edge axis (2-D meshes) the first; ``None`` is ``(1, 1)``."""
    if mesh is None:
        return 1, 1
    shape = tuple(int(s) for s in mesh.shape)
    return (shape[0] if len(shape) > 1 else 1), shape[-1]


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def row_partition(n_rows: int, n_shards: int, *,
                  align: int = 1) -> Tuple[int, np.ndarray]:
    """Contiguous-chunk pad-and-mask partition of ``n_rows`` over
    ``n_shards`` ranks: ``(cap, pad_map)``, with ``cap = ceil(n_rows /
    n_shards)`` snapped up to a multiple of ``align`` and ``pad_map`` an
    i32[cap * n_shards] gather map, the identity on the real rows, then the
    LAST real row repeated over the padding.  With ``align`` a power of two
    dividing the admission bucket capacity every chunk boundary lands on a
    bucket multiple."""
    if n_rows < 1:
        raise ValueError(f"row_partition needs at least one row, got {n_rows}")
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    cap = -(-n_rows // n_shards)
    cap = -(-cap // align) * align
    pad_map = np.minimum(
        np.arange(cap * n_shards, dtype=np.int32), np.int32(n_rows - 1))
    return cap, pad_map


def replicate(tree, mesh):
    """``tree`` (a tensor, or a tuple / NamedTuple of them) on this rank's
    device of ``mesh``: every rank holds a whole copy."""
    dev = mesh_device(mesh)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return type(tree)(*(replicate(t, mesh) for t in tree)) \
        if hasattr(tree, "_fields") else type(tree)(replicate(t, mesh) for t in tree)


@identity_cache(max_entries=8)
def replicated_arrays(mesh, *arrays):
    """:func:`replicate` of ``arrays``, identity-cached per ``(mesh,
    arrays)``: graph fields and permutations are immutable, so a serving
    horizon places them once."""
    return replicate(tuple(arrays), mesh)


__all__ = [
    "make_mesh",
    "query_axis",
    "query_mesh",
    "edge_axis",
    "serve_mesh",
    "mesh_shape",
    "mesh_device",
    "backend_for",
    "init_process_group",
    "row_partition",
    "replicate",
    "replicated_arrays",
]
