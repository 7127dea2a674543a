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

A round reduces its candidates ``EDGE_CHUNK`` at a time (edges x source
rows), min- or float64-sum-combining the chunks' partials: at the paper's
1e9 edges the int64 segment ids and masks of one pass over all candidates
would not fit beside the edges on one card.  Min is exact and the float
sums round once, after the last chunk, so the result does not depend on
the chunk size.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import obs
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
EDGE_CHUNK = 1 << 27   # candidates (edges x source rows) reduced per pass


def _chunks(n: int, per: int):
    """Slices of ``range(n)`` of ``per`` elements (the last shorter)."""
    per = max(int(per), 1)
    return [slice(lo, min(lo + per, n)) for lo in range(0, n, per)] or [slice(0, 0)]


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
    arrivals into destinations ([S_loc, V], INT_INF where none), over
    ``EDGE_CHUNK`` candidates a pass."""
    rows = arrival.shape[0]
    row_off = torch.arange(rows, device=arrival.device)[:, None] * n_vertices
    out = None
    for sl in _chunks(s.shape[0], EDGE_CHUNK // max(rows, 1)):
        arr_src = arrival[:, s[sl].long()]                 # [S_loc, K]
        follows = (arr_src < t1[sl]) if strict else (arr_src <= t1[sl])
        ok = ok_base[None, sl] & follows & (arr_src < INT_INF)
        ids = (row_off + d[sl].long()[None, :]).reshape(-1)
        cand = t2[None, sl].expand(rows, -1).reshape(-1)
        part = segment_combine(cand, ids, rows * n_vertices, "min", mask=ok.reshape(-1))
        out = part if out is None else torch.minimum(out, part, out=out)
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
    as ``jax.lax.top_k`` orders them; the rows are sorted ``EDGE_CHUNK``
    entries at a time.  With fewer than K improvements the rest are INT_INF
    entries, which scatter harmlessly."""
    rows = arrival.shape[0]
    vals = torch.empty((rows, k), dtype=arrival.dtype, device=arrival.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=arrival.device)
    for sl in _chunks(rows, EDGE_CHUNK // max(n_vertices, 1)):
        keyed = torch.where(partial[sl] < arrival[sl], partial[sl], INT_INF)
        v, i = torch.sort(keyed, dim=1, stable=True)
        vals[sl], idx[sl] = v[:, :k], i[:, :k]
    if axis is not None:
        vals, idx = all_gather(vals[None], axis), all_gather(idx[None], axis)
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
    """Pad the edges to the shard multiple and sort each shard's slice by
    t_start (stable), so the selective round's local binary search is
    valid.  Returns this rank's ``(src, dst, ts, te, valid)`` chunks on its
    device, sorted there (arrays or tensors in; tensors already on the
    device are not copied to the host)."""
    n, i = _n_shards(mesh)
    dev = mesh_device(mesh)
    e = int(src.shape[0])
    pad = (-e) % n
    per = (e + pad) // n
    sl = slice(i * per, (i + 1) * per)

    def mine(a, fill=0):
        a = torch.as_tensor(a, device=dev)
        if pad:
            a = torch.cat([a, a.new_full((pad,), fill)])
        return a[sl]

    ts_sorted, order = torch.sort(mine(ts), stable=True)
    out = [mine(a)[order] for a in (src, dst)] + [ts_sorted.contiguous(), mine(te)[order]]
    valid = torch.ones(e, dtype=torch.bool, device=dev)
    out.append(mine(valid, False)[order])
    return tuple(a.contiguous() for a in out)


def make_pagerank_round(mesh, n_vertices: int, damping: float = 0.85):
    """One distributed temporal-PageRank power iteration (sum combine):
    ``pr_round(pr, src, dst, ts, te, evalid, inv_out_deg, window)`` with
    ``pr`` and ``inv_out_deg`` the whole [V] vectors on every rank.  The
    float32 contributions add in float64 (across chunks and ranks too) and
    round once."""
    axis = edge_mesh_axis(mesh)

    def pr_round(pr, src, dst, ts, te, evalid, inv_out_deg, window):
        ta, tb = int(window[0]), int(window[1])
        agg = None
        for sl in _chunks(src.shape[0], EDGE_CHUNK):
            ok = evalid[sl] & (ts[sl] >= ta) & (te[sl] <= tb)
            s = src[sl].long()
            contrib = (pr[s] * inv_out_deg[s]).double()
            part = segment_combine(contrib, dst[sl], n_vertices, "sum", mask=ok)
            agg = part if agg is None else agg.add_(part)
        if axis is not None:
            all_reduce(agg, "sum", axis)
        return (1.0 - damping) / n_vertices + damping * agg.to(pr.dtype)

    return pr_round


def make_cc_round(mesh, n_vertices: int):
    """One distributed hash-min label-propagation round (temporal CC) with
    the pointer jump: ``cc_round(labels, src, dst, ts, te, evalid, window)``
    on the whole [V] labels."""
    axis = edge_mesh_axis(mesh)

    def cc_round(labels, src, dst, ts, te, evalid, window):
        ta, tb = int(window[0]), int(window[1])
        partial = None
        for sl in _chunks(src.shape[0], EDGE_CHUNK):
            ok = evalid[sl] & (ts[sl] >= ta) & (te[sl] <= tb)
            s, d = src[sl].long(), dst[sl].long()
            fwd = segment_combine(labels[s], d, n_vertices, "min", mask=ok)
            part = torch.minimum(fwd, segment_combine(labels[d], s, n_vertices, "min",
                                                      mask=ok))
            partial = part if partial is None else torch.minimum(partial, part,
                                                                 out=partial)
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
    whole [S, V]) and reaches the final gather together.  Under a profiler
    session the query records the spans ``ea.query`` (the root),
    ``fixpoint.round`` (each round, with its device extent) holding
    ``fixpoint.relax`` and ``fixpoint.converge`` (the compare, the flag's
    all-reduce and its read), and ``ea.gather`` (:mod:`repro_torch.obs`).

    A plan with ``budget > 0`` binary-searches each shard, which is correct
    only on per-shard t_start-sorted edges; the caller asserts that with
    ``edges_time_sorted=True``, else this raises."""
    if plan is not None and plan.budget > 0 and not edges_time_sorted:
        raise ValueError(
            "plan.budget > 0 requires per-shard t_start-sorted edges: pass "
            "sort_edges_by_time_per_shard(...) output and edges_time_sorted=True")
    with obs.span("ea.query"):
        n_vertices = arrival0.shape[-1]
        round_fn = make_ea_round_plan(mesh, n_vertices, plan, strict)
        src, dst, ts, te = edge_arrays
        arrival = local_rows(mesh, arrival0.to(mesh_device(mesh)))
        world = world_axis()
        rounds = 0
        for _ in range(max_rounds):
            with obs.span("fixpoint.round", stage=True):
                with obs.span("fixpoint.relax"):
                    new = round_fn(arrival, src, dst, ts, te, edge_valid, window)
                rounds += 1
                obs.count("fixpoint.rounds")
                with obs.span("fixpoint.converge", stage=True):
                    done = torch.tensor([int(torch.equal(new, arrival))],
                                        dtype=torch.int32, device=arrival.device)
                    arrival = new
                    settled = int(all_reduce(done, "min", world)[0])
                    obs.count("host_reads", 2)
            if settled:
                break
        with obs.span("ea.gather"):
            out = gather_rows(mesh, arrival)
    return (out, rounds) if with_rounds else out


__all__ = [
    "EDGE_AXES",
    "EDGE_CHUNK",
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
