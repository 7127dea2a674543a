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
name to size.

Sharding is DTensor on a ``DeviceMesh`` (``torch.distributed.tensor``), the
counterpart of the reference's GSPMD ``NamedSharding``.  ``placements``
turns a spec into one placement per mesh dimension: ``Shard(d)`` where
tensor dimension ``d`` maps to that mesh dimension, else ``Replicate()``.
A dimension mapped to several mesh axes (``batch -> ("pod", "data")``)
takes ``Shard(d)`` on each, in the mesh's dimension order, which is the
reference's major-to-minor order.  ``named_sharding`` returns ``(mesh,
placements)`` and ``spec_tree_sharding`` maps a tree of logical-axis tuples
onto those pairs.

``constrain`` and ``gather_fsdp`` are the identity outside a mesh, as in the
reference.  Under ``use_mesh`` of a ``DeviceMesh`` they ``redistribute`` a
DTensor to its spec's placements; a plain tensor is taken as replicated on
the mesh (the value GSPMD gives an unannotated array) and comes back a
DTensor.  A mesh given as a mapping of axis sizes has no devices to place
on: under it they return ``x`` unchanged, and ``logical_spec`` works as
with a ``DeviceMesh``.  Redistribution moves data, never values: whatever
is sharded computes what the unsharded step computes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

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
    """The active mesh and rules.  Under a ``DeviceMesh`` a plain tensor that
    meets a DTensor is taken as replicated on the mesh (DTensor's
    ``implicit_replication``), as GSPMD takes an unannotated array."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = AxisRules({**DEFAULT_RULES, **rules})
    try:
        if mesh is None or isinstance(mesh, Mapping):
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
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


def placements(dim_sizes: Sequence[Optional[int]], logical_axes: Sequence[Optional[str]],
               mesh=None, rules: Optional[AxisRules] = None):
    """The DTensor placements of ``logical_spec(dim_sizes, logical_axes)`` on
    ``mesh`` (the active one unless given): one per mesh dimension.  A
    dimension of size 1 stays replicated: it divides only over mesh axes of
    size 1, where both layouts are one, and DTensor refuses to reshape a
    sharded dimension away."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh if mesh is not None else _CTX.mesh
    names = list(_mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, axes in enumerate(logical_spec(dim_sizes, logical_axes, mesh, rules)):
        if dim_sizes[d] == 1:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dimensions: "
                                 f"{tuple(logical_axes)}")
            out[i] = Shard(d)
    return out


def named_sharding(dim_sizes, logical_axes, mesh=None):
    """``(mesh, placements)`` of a tensor with these logical axes on
    ``mesh`` (the active one unless given); ``None`` with no mesh."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return None
    return mesh, placements(dim_sizes, logical_axes, mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _map_axes(fn, axes_tree, tree):
    """``fn(axes, leaf)`` over a tree of logical-axis tuples and the tree of
    the same structure beside it (dicts and lists)."""
    if _is_axes(axes_tree):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, tree[k]) for k, v in axes_tree.items()}
    return type(axes_tree)(_map_axes(fn, a, t) for a, t in zip(axes_tree, tree))


def spec_tree_sharding(spec_tree, shape_tree, mesh):
    """A tree of logical-axis tuples and the matching shapes (tensors or
    shape tuples) as a tree of ``(mesh, placements)``."""
    return _map_axes(lambda axes, shaped: named_sharding(
        tuple(getattr(shaped, "shape", shaped)), axes, mesh), spec_tree, shape_tree)


def distribute_tree(tree, axes_tree, mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """Every tensor of ``tree`` as a DTensor on ``mesh``, placed by its
    logical axes in ``axes_tree`` (under ``rules`` over the defaults when
    given, else the active rules).  Every rank passes the same values; each
    keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor

    rules_obj = AxisRules({**DEFAULT_RULES, **rules}) if rules else None
    return _map_axes(lambda axes, t: distribute_tensor(
        t.detach(), mesh, placements(t.shape, axes, mesh, rules_obj)), axes_tree, tree)


def zeros_placed(shape, logical_axes, mesh, dtype, device):
    """Zeros of ``shape`` as a DTensor on ``mesh``, placed by their logical
    axes, each rank allocating only its own shard (on ``device``)."""
    from torch.distributed.tensor import DTensor, Shard

    pl = placements(shape, logical_axes, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)    # logical_spec shards only what divides
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full_value(x):
    """A DTensor's whole value as a plain tensor on every rank (a collective:
    every rank must call it); any other value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements when both are DTensors
    and they differ (e.g. a ``Partial`` reduction stored into replicated
    state); otherwise ``x``."""
    if not (is_dtensor(x) and is_dtensor(ref)) or x.placements == ref.placements:
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def _placed(x, logical_axes):
    mesh = _CTX.mesh
    if mesh is None or isinstance(mesh, Mapping):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, placements(x.shape, logical_axes, mesh))


def replicated(x, *dims: int):
    """``x`` with tensor dimensions ``dims`` whole on every rank: a DTensor
    sharded along one of them is redistributed to ``Replicate()`` there; any
    other tensor comes back as it is.  Used before an op whose DTensor
    sharding rule fails or is missing for a sharded dimension."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    want = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
            for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


def axis0_local(fn, n_out: int, *tensors):
    """``fn`` over whole slices of axis 0 (rows that compute independently:
    dispatch groups, batch rows).  On plain tensors it is called as it is.
    On DTensors it runs in ``local_map`` on each rank's own slices: axis 0
    keeps the first tensor's sharding, every other axis is made whole (a
    plain tensor is taken as replicated).  Ops without a DTensor sharding
    rule, or whose rule fails, run inside on local tensors."""
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t for t in tensors if is_dtensor(t)).device_mesh
    pl = tuple(p if p == Shard(0) else Replicate() for p in tensors[0].placements) \
        if is_dtensor(tensors[0]) else (Replicate(),) * mesh.ndim
    tensors = [t if is_dtensor(t) else
               DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
               for t in tensors]
    out_pl = list(pl) if n_out == 1 else (pl,) * n_out
    return local_map(fn, out_placements=out_pl, in_placements=(pl,) * len(tensors),
                     device_mesh=mesh, redistribute_inputs=True)(*tensors)


def _on_local_shards(fn, operands, in_pl, out_pl, mesh, n_out: int = 1):
    """``fn`` on each rank's own shards of ``operands`` (redistributed to
    ``in_pl`` first; a plain tensor taken as replicated), its result a
    DTensor with placements ``out_pl`` (with ``n_out`` > 1, a tuple of that
    many results, each placed so).  An operand whole on a mesh dimension
    where the result is split (``Shard`` or ``Partial``) gets its gradient
    there as a pending sum of the ranks' shares."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    operands = [t if is_dtensor(t) else
                DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                for t in operands]
    grad_pl = tuple([p if p != Replicate() or out_pl[m] == Replicate() else Partial()
                     for m, p in enumerate(pl)] for pl in in_pl)
    out_placements = list(out_pl) if n_out == 1 else (tuple(out_pl),) * n_out
    return local_map(fn, out_placements=out_placements, in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*operands)


def local_einsum(equation: str, *operands, fn=None):
    """``fn(*operands)`` (``torch.einsum(equation, ...)`` unless given: a
    function that computes ``equation``); on DTensors each rank runs it on
    its own shards (``local_map``), so no DTensor view or einsum rule is
    involved.  Per mesh dimension, the first operand sharded there names
    the index letter that stays sharded: every operand holding that letter
    is sharded along it, the others are made whole on that dimension, and
    the result is sharded along the letter, or a pending sum (``Partial``)
    where the letter is summed over."""
    if fn is None:
        fn = lambda *t: torch.einsum(equation, *t)  # noqa: E731
    if not any(is_dtensor(t) for t in operands):
        return fn(*operands)
    from torch.distributed.tensor import Partial, Replicate, Shard

    ins, out = equation.replace(" ", "").split("->")
    specs = ins.split(",")
    if "..." in ins:
        n = max(t.ndim - len(sp) + 3 for t, sp in zip(operands, specs) if "..." in sp)
        fill = "".join(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in ins)[:n]
        specs = [sp.replace("...", fill[n - (t.ndim - len(sp) + 3):])
                 for t, sp in zip(operands, specs)]
        out = out.replace("...", fill)
    mesh = next(t for t in operands if is_dtensor(t)).device_mesh
    in_pl = [[Replicate()] * mesh.ndim for _ in operands]
    out_pl = [Replicate()] * mesh.ndim
    for m in range(mesh.ndim):
        letter = next((sp[t.placements[m].dim] for t, sp in zip(operands, specs)
                       if is_dtensor(t) and isinstance(t.placements[m], Shard)), None)
        if letter is None:
            continue
        for k, sp in enumerate(specs):
            if letter in sp:
                in_pl[k][m] = Shard(sp.index(letter))
        out_pl[m] = Shard(out.index(letter)) if letter in out else Partial()
    return _on_local_shards(fn, operands, in_pl, out_pl, mesh)


def local_lookup(table, ids):
    """``table[ids]`` (rows of ``table`` [V, ...] at integer ``ids``); on
    DTensors each rank looks its own rows up: where the table's rows are
    sharded, ids outside the rank's rows give zeros and the result is a
    pending sum (``Partial``) there; ids keep their sharding, a sharded
    column of the table stays sharded."""
    if not (is_dtensor(table) or is_dtensor(ids)):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (table if is_dtensor(table) else ids).device_mesh
    tp = list(table.placements) if is_dtensor(table) else [Replicate()] * mesh.ndim
    ip = list(ids.placements) if is_dtensor(ids) else [Replicate()] * mesh.ndim
    t_in, i_in, out_pl, row_dims = [], [], [], []
    for m in range(mesh.ndim):
        if isinstance(tp[m], Shard) and tp[m].dim == 0:
            t_in.append(Shard(0))
            i_in.append(Replicate())
            out_pl.append(Partial())
            row_dims.append(m)
        elif isinstance(tp[m], Shard):
            t_in.append(tp[m])
            i_in.append(Replicate())
            out_pl.append(Shard(ids.ndim + tp[m].dim - 1))
        elif isinstance(ip[m], Shard):
            t_in.append(Replicate())
            i_in.append(ip[m])
            out_pl.append(ip[m])
        else:
            t_in.append(Replicate())
            i_in.append(Replicate())
            out_pl.append(Replicate())
    coord = 0
    for m in row_dims:
        coord = coord * mesh.size(m) + mesh.get_local_rank(m)

    def lookup(t, i):
        if not row_dims:
            return t[i]
        rows = i.long() - coord * t.shape[0]
        held = (rows >= 0) & (rows < t.shape[0])
        got = t[rows.clamp(0, t.shape[0] - 1)]
        return got * held.reshape(held.shape + (1,) * (got.ndim - held.ndim)).to(got.dtype)

    return _on_local_shards(lookup, (table, ids), (t_in, i_in), out_pl, mesh)


def local_segment_sum(values, ids, n: int):
    """``zeros(n, ...).index_add(0, ids, values)``; on DTensors each rank sums
    its own rows: where values or ids are sharded along axis 0 both are,
    and the result is a pending sum (``Partial``) there; a sharded later
    axis of ``values`` stays sharded."""
    if not (is_dtensor(values) or is_dtensor(ids)):
        return values.new_zeros((n,) + tuple(values.shape[1:])).index_add(0, ids, values)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (values if is_dtensor(values) else ids).device_mesh
    vp = list(values.placements) if is_dtensor(values) else [Replicate()] * mesh.ndim
    ip = list(ids.placements) if is_dtensor(ids) else [Replicate()] * mesh.ndim
    v_in, i_in, out_pl = [], [], []
    for m in range(mesh.ndim):
        if Shard(0) in (vp[m], ip[m]):
            v_in.append(Shard(0))
            i_in.append(Shard(0))
            out_pl.append(Partial())
        elif isinstance(vp[m], Shard):
            v_in.append(vp[m])
            i_in.append(Replicate())
            out_pl.append(vp[m])
        else:
            v_in.append(Replicate())
            i_in.append(Replicate())
            out_pl.append(Replicate())
    return _on_local_shards(
        lambda v, i: v.new_zeros((n,) + tuple(v.shape[1:])).index_add(0, i, v),
        (values, ids), (v_in, i_in), out_pl, mesh)


def local_edge_sums(fn, src, dst, *operands, n_out: int = 1):
    """``fn(src, dst, *operands)``: sums over the edges ``src`` / ``dst``
    [E] into node rows (a message-passing layer's edge stage).  On DTensors
    each rank runs ``fn`` on its own edges: ``src`` and ``dst`` keep their
    axis-0 sharding (which may be uneven), every other operand is made
    whole, and the ``n_out`` results are pending sums (``Partial``) where
    the edges are sharded.  Every edge-sized tensor is made inside ``fn``
    from the rank's own rows, so none crosses into DTensor's rules."""
    tensors = (src, dst, *operands)
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = next(t for t in tensors if is_dtensor(t)).device_mesh
    ep = list(src.placements) if is_dtensor(src) else [Replicate()] * mesh.ndim
    edge_pl = [Shard(0) if p == Shard(0) else Replicate() for p in ep]
    whole = [Replicate()] * mesh.ndim
    out_pl = [Partial() if p == Shard(0) else Replicate() for p in edge_pl]
    return _on_local_shards(fn, tensors, (edge_pl, edge_pl) + (whole,) * len(operands),
                            out_pl, mesh, n_out)


def reduced(x):
    """``x`` with every pending (``Partial``) placement reduced to
    ``Replicate()``; any other tensor as it is.  A lookup into a row-sharded
    table comes back as DTensor's masked partial, which later reshapes and
    einsums mishandle: it is reduced at the lookup."""
    from torch.distributed.tensor import Partial, Replicate

    if not is_dtensor(x) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                          for p in x.placements])


def constrain(x, *logical_axes: Optional[str]):
    """A sharding constraint by logical names (the reference's
    ``with_sharding_constraint``); the identity with no mesh."""
    return _placed(x, logical_axes)


def gather_fsdp(x, *logical_axes: Optional[str]):
    """The ZeRO-3 weight gather at use time: ``x`` placed by its logical axes
    with the ``"fsdp"`` dimension replicated; the identity with no mesh."""
    return _placed(x, tuple(None if a == "fsdp" else a for a in logical_axes))


__all__ = ["DEFAULT_RULES", "MeshAxes", "AxisRules", "use_mesh", "current_mesh",
           "logical_spec", "placements", "named_sharding", "spec_tree_sharding",
           "distribute_tree", "zeros_placed", "is_dtensor", "full_value", "placed_like",
           "replicated", "reduced", "local_einsum", "local_lookup", "local_segment_sum",
           "local_edge_sums", "axis0_local",
           "constrain", "gather_fsdp"]
