"""Distributed temporal-graph engine: the edge-partitioned TemporalEdgeMap.

Sharding model, as in the JAX package:

  * edges   -> sharded over ``("pod", "data")`` (the dimensions of the mesh
               that are present): each rank owns one contiguous chunk;
  * sources -> sharded over ``"model"``: multi-source batches are
               embarrassingly parallel (the paper's 100-source sweeps);
  * vertex state -> replicated within a source chunk.

One relaxation round is a local masked segment reduce over the rank's edge
chunk plus ONE collective (a min- or sum-all-reduce of the [S_loc, V]
partial) over the edge dimension: the per-round traffic is one
associative combine of the vertex state, never per-edge messages.

``make_ea_round_plan`` builds the earliest-arrival round from two flags of
an :class:`~repro_torch.engine.plan.AccessPlan`:

  * gather:   ``plan.budget > 0`` — each shard keeps its edges t_start
              sorted (:func:`sort_edges_by_time_per_shard`), binary-searches
              the window and gathers a fixed budget of candidates;
  * exchange: ``plan.exchange_budget > 0`` — each shard all-gathers only its
              K best improvements per source row instead of min-reducing
              the whole state; improvements beyond K are recomputed next
              round, so the fixpoint is the dense one.

A round function takes and returns THIS rank's source rows (``local_rows``)
and this rank's edge chunk (:func:`shard_edges`); at world size 1 those are
the whole arrays.  The combines here are ``scatter_reduce_`` / ``index_add_``
plus a collective, as the reference's are ``segment_*`` plus ``pmin`` /
``psum``: no tile kernel runs on this path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import to_numpy
from repro_torch.distributed.collectives import (
    MeshAxis,
    all_gather,
    all_reduce,
    mesh_axis,
    world_axis,
)
from repro_torch.distributed.query_shard import mesh_device
from repro_torch.engine.backends import segment_combine
from repro_torch.engine.plan import AccessPlan, make_plan
from repro_torch.kernels.temporal_edgemap import INT_INF

EDGE_AXES = ("pod", "data")
SOURCE_AXIS = "model"


def _edge_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in EDGE_AXES if a in mesh.mesh_dim_names)


def edge_mesh_axis(mesh) -> Optional[MeshAxis]:
    """The edge dimension(s) of ``mesh`` as one axis: ``None`` when the mesh
    has no edge dimension (every rank then holds every edge); two edge
    dimensions are flattened into one."""
    axes = _edge_axes(mesh)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh_axis(mesh, axes[0])
    flat = mesh[axes]._flatten("edges")
    return mesh_axis(flat, "edges")


def source_mesh_axis(mesh) -> Optional[MeshAxis]:
    """The source dimension (``"model"``) of ``mesh``, if it has one."""
    return mesh_axis(mesh, SOURCE_AXIS) if SOURCE_AXIS in mesh.mesh_dim_names \
        else None


def _n_shards(mesh) -> Tuple[int, int]:
    ax = edge_mesh_axis(mesh)
    return (1, 0) if ax is None else (ax.size, ax.index)


def local_rows(mesh, arrival: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous chunk of the [S, V] source rows (sources shard
    over ``"model"``; S must divide by its size, as under ``shard_map``)."""
    ax = source_mesh_axis(mesh)
    if ax is None:
        return arrival
    S = arrival.shape[0]
    if S % ax.size:
        raise ValueError(
            f"{S} source rows do not divide over the {ax.size} ranks of the "
            f"{SOURCE_AXIS!r} mesh dimension")
    per = S // ax.size
    return arrival[ax.index * per:(ax.index + 1) * per]


def gather_rows(mesh, rows: torch.Tensor) -> torch.Tensor:
    """The [S, V] state from every rank's source rows."""
    ax = source_mesh_axis(mesh)
    return rows if ax is None else all_gather(rows, ax)


def shard_edges(mesh, *arrays):
    """Pad each edge array to the edge-shard multiple (with 0 / False) and
    return this rank's contiguous chunk of each, on its device."""
    n, i = _n_shards(mesh)
    dev = mesh_device(mesh)
    out = []
    for arr in arrays:
        a = torch.as_tensor(arr)
        pad = (-a.shape[0]) % n
        if pad:
            a = torch.cat([a, a.new_zeros(pad)])
        per = a.shape[0] // n
        out.append(a[i * per:(i + 1) * per].to(dev).contiguous())
    return out


# ---------------------------------------------------------------------------
# shard-local round primitives
# ---------------------------------------------------------------------------

def _gather_shard_candidates(src, dst, ts, te, evalid, ta, tb, budget: int):
    """Candidate selection on one edge shard.  ``budget == 0``: the whole
    shard, window-masked (scan).  ``budget > 0``: ``ts`` is t_start-sorted
    within the shard, so the window is a binary search and a fixed-budget
    gather."""
    if budget <= 0:
        ok = evalid & (ts >= ta) & (te <= tb)
        return src, dst, ts, te, ok
    bounds = torch.tensor([ta, tb], dtype=ts.dtype, device=ts.device)
    lo = torch.searchsorted(ts, bounds[:1], side="left")
    hi = torch.searchsorted(ts, bounds[1:], side="right")
    at = lo + torch.arange(budget, device=ts.device)
    pos = at.clamp(max=ts.shape[0] - 1)
    s, d, t1, t2, ev = src[pos], dst[pos], ts[pos], te[pos], evalid[pos]
    ok = ev & (at < hi) & (t2 <= tb)
    return s, d, t1, t2, ok


def _relax_partial(arrival, s, d, t1, t2, ok_base, n_vertices: int, strict: bool):
    """Shard-local EA relax: per source row, the segment min of candidate
    arrivals into destinations ([S_loc, V], INT_INF where none)."""
    arr_src = arrival[:, s.long()]                         # [S_loc, K]
    follows = (arr_src < t1) if strict else (arr_src <= t1)
    ok = ok_base[None, :] & follows & (arr_src < INT_INF)
    rows = arrival.shape[0]
    ids = (torch.arange(rows, device=arrival.device)[:, None] * n_vertices
           + d.long()[None, :]).reshape(-1)
    cand = t2[None, :].expand(rows, -1).reshape(-1)
    out = segment_combine(cand, ids, rows * n_vertices, "min", mask=ok.reshape(-1))
    return out.reshape(rows, n_vertices)


def _exchange_dense(arrival, partial, axis):
    """Dense combine: one min-all-reduce of the whole [S_loc, V] partial."""
    if axis is not None:
        all_reduce(partial, "min", axis)
    return torch.minimum(arrival, partial)


def _exchange_topk(arrival, partial, axis, n_vertices: int, k: int):
    """Frontier-sparse combine: every shard all-gathers only its K best
    improvements (vertex id, arrival) per source row and applies the union
    with a local scatter-min.  The K are picked by a STABLE sort of the
    keyed values, so among equal arrivals the lower vertex id goes first,
    as ``jax.lax.top_k`` orders them.  With fewer than K improvements the
    rest are INT_INF entries, which scatter harmlessly."""
    keyed = torch.where(partial < arrival, partial, INT_INF)
    vals, idx = torch.sort(keyed, dim=1, stable=True)
    vals, idx = vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()
    if axis is not None:
        vals, idx = all_gather(vals[None], axis), all_gather(idx[None], axis)
    rows = arrival.shape[0]
    ids = (torch.arange(rows, device=arrival.device)[None, :, None] * n_vertices
           + idx.long().reshape(-1, rows, k))
    upd = segment_combine(vals.reshape(-1), ids.reshape(-1), rows * n_vertices, "min")
    return torch.minimum(arrival, upd.reshape(rows, n_vertices))


# ---------------------------------------------------------------------------
# THE earliest-arrival round builder
# ---------------------------------------------------------------------------

def make_ea_round_plan(mesh, n_vertices: int, plan: Optional[AccessPlan] = None,
                       strict: bool = False):
    """One distributed earliest-arrival relaxation round from a plan:
    ``ea_round(arrival, src, dst, ts, te, evalid, window)`` maps this rank's
    source rows ([S_loc, V]) to their next state, over this rank's edge
    chunk.  ``plan.budget > 0`` needs per-shard t_start-sorted edges
    (:func:`sort_edges_by_time_per_shard`); ``hybrid`` has no shard form."""
    plan = plan if plan is not None else make_plan("scan")
    if plan.method == "hybrid":
        raise ValueError(
            "hybrid (per-vertex) access has no shard-granular form; "
            "use make_plan('index', budget=...) for the selective round")
    axis = edge_mesh_axis(mesh)
    budget = plan.budget
    kx = min(plan.exchange_budget, n_vertices) if plan.exchange_budget else 0

    def ea_round(arrival, src, dst, ts, te, evalid, window):
        ta, tb = int(window[0]), int(window[1])
        s, d, t1, t2, ok = _gather_shard_candidates(
            src, dst, ts, te, evalid, ta, tb, budget)
        partial = _relax_partial(arrival, s, d, t1, t2, ok, n_vertices, strict)
        if kx:
            return _exchange_topk(arrival, partial, axis, n_vertices, kx)
        return _exchange_dense(arrival, partial, axis)

    return ea_round


def sort_edges_by_time_per_shard(mesh, src, dst, ts, te):
    """Host side: pad the edges to the shard multiple and sort each shard's
    slice by t_start (stable), so the selective round's local binary search
    is valid.  Returns this rank's ``(src, dst, ts, te, valid)`` chunks."""
    n, i = _n_shards(mesh)
    e = int(np.asarray(to_numpy(src)).shape[0])
    pad = (-e) % n
    arrs = [np.pad(to_numpy(a), (0, pad), constant_values=0) for a in (src, dst, ts, te)]
    valid = np.pad(np.ones(e, bool), (0, pad), constant_values=False)
    per = (e + pad) // n
    sl = slice(i * per, (i + 1) * per)
    order = np.argsort(arrs[2][sl], kind="stable")
    dev = mesh_device(mesh)
    return tuple(torch.from_numpy(np.ascontiguousarray(a[sl][order])).to(dev)
                 for a in arrs + [valid])


def make_pagerank_round(mesh, n_vertices: int, damping: float = 0.85):
    """One distributed temporal-PageRank power iteration (sum combine):
    ``pr_round(pr, src, dst, ts, te, evalid, inv_out_deg, window)`` with
    ``pr`` and ``inv_out_deg`` the whole [V] vectors on every rank."""
    axis = edge_mesh_axis(mesh)

    def pr_round(pr, src, dst, ts, te, evalid, inv_out_deg, window):
        ta, tb = int(window[0]), int(window[1])
        ok = evalid & (ts >= ta) & (te <= tb)
        s = src.long()
        contrib = pr[s] * inv_out_deg[s]
        agg = segment_combine(contrib, dst, n_vertices, "sum", mask=ok, axis=axis)
        return (1.0 - damping) / n_vertices + damping * agg

    return pr_round


def make_cc_round(mesh, n_vertices: int):
    """One distributed hash-min label-propagation round (temporal CC) with
    the pointer jump: ``cc_round(labels, src, dst, ts, te, evalid, window)``
    on the whole [V] labels."""
    axis = edge_mesh_axis(mesh)

    def cc_round(labels, src, dst, ts, te, evalid, window):
        ta, tb = int(window[0]), int(window[1])
        ok = evalid & (ts >= ta) & (te <= tb)
        s, d = src.long(), dst.long()
        fwd = segment_combine(labels[s], d, n_vertices, "min", mask=ok)
        bwd = segment_combine(labels[d], s, n_vertices, "min", mask=ok)
        partial = torch.minimum(fwd, bwd)
        if axis is not None:
            all_reduce(partial, "min", axis)
        new = torch.minimum(labels, partial)
        return torch.minimum(new, new[new.long()])     # pointer jump

    return cc_round


def run_distributed_ea(
    mesh,
    arrival0,             # [S, V] initialized (ta at sources, INF elsewhere)
    edge_arrays,          # this rank's (src, dst, ts, te) chunks
    edge_valid,
    window,
    max_rounds: int = 64,
    strict: bool = False,
    plan: Optional[AccessPlan] = None,
    edges_time_sorted: bool = False,
    with_rounds: bool = False,
):
    """The fixpoint loop around the distributed round; returns the whole
    [S, V] arrivals on every rank (and the round count with
    ``with_rounds``).  Each rank relaxes its source rows; the loop stops
    when no rank's rows changed, a flag min-reduced over the WORLD every
    round, so every rank runs the same rounds (the JAX loop's test on the
    whole [S, V]) and reaches the final gather together.

    A plan with ``budget > 0`` binary-searches each shard, which is correct
    only on per-shard t_start-sorted edges; the caller asserts that with
    ``edges_time_sorted=True``, else this raises."""
    if plan is not None and plan.budget > 0 and not edges_time_sorted:
        raise ValueError(
            "plan.budget > 0 requires per-shard t_start-sorted edges: pass "
            "sort_edges_by_time_per_shard(...) output and edges_time_sorted=True")
    n_vertices = arrival0.shape[-1]
    round_fn = make_ea_round_plan(mesh, n_vertices, plan, strict)
    src, dst, ts, te = edge_arrays
    arrival = local_rows(mesh, arrival0.to(mesh_device(mesh)))
    world = world_axis()
    rounds = 0
    for _ in range(max_rounds):
        new = round_fn(arrival, src, dst, ts, te, edge_valid, window)
        rounds += 1
        done = torch.tensor([int(torch.equal(new, arrival))], dtype=torch.int32,
                            device=arrival.device)
        arrival = new
        if int(all_reduce(done, "min", world)[0]):
            break
    out = gather_rows(mesh, arrival)
    return (out, rounds) if with_rounds else out


__all__ = [
    "EDGE_AXES",
    "edge_mesh_axis",
    "source_mesh_axis",
    "local_rows",
    "gather_rows",
    "shard_edges",
    "make_ea_round_plan",
    "sort_edges_by_time_per_shard",
    "make_pagerank_round",
    "make_cc_round",
    "run_distributed_ea",
]
