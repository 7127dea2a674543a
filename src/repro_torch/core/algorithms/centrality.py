"""Temporal betweenness centrality (Brandes over the earliest-arrival DAG).

Forward: path counts sigma accumulate in arrival-time-bucket order over the
optimal-edge DAG (an edge (s, d, [ts, te]) is EA-optimal iff it is
window-valid, satisfies the ordering predicate against t[s], and
te == t[d]).  Backward: dependencies delta accumulate in reverse bucket
order.  Exact when arrivals strictly increase along optimal paths and the
bucket count is at least the number of distinct arrival times.

``temporal_betweenness_over_view`` is the multi-source entry point: row q
is the dependency vector of ``(sources[q], windows[q])`` over one prebuilt
view, the EA upsweep one batched fixpoint over all rows.  The optimal
edges of all rows are compacted once and grouped by their destination's
bucket (a stable sort, so each bucket keeps the edges' view order), and
each bucket pass sums only its own edges, on the segment path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.algorithms.paths import _earliest_arrival_over_view, bucket_bounds
from repro_torch.core.edgemap import INT_INF, EdgeView, ensure_plan, union_window, view_for_plan
from repro_torch.core.predicates import OrderingPredicateType, edge_follows
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex
from repro_torch.distributed.collectives import all_reduce
from repro_torch.engine.fixpoint import FixpointRunner
from repro_torch.engine.frontier import ladder_eligible
from repro_torch.engine.plan import AccessPlan


def _brandes_rows(edges, valid, windows, sources, t, n_buckets: int,
                  pred: OrderingPredicateType, n_vertices: int,
                  axis=None) -> torch.Tensor:
    """delta[Q, V] from the rows' EA labels ``t`` [Q, V] and validity
    ``valid`` [Q, E'].  ``axis`` (the plan's ``edge_axis``) makes each
    bucket pass's sum global across the edge ranks; every rank runs the
    same P passes, so the ranks stay in lockstep."""
    V, P = n_vertices, n_buckets
    Q = t.shape[0]
    dev = t.device
    src, dst = edges.src.long(), edges.dst.long()
    rows = torch.arange(Q, device=dev)
    reached = t < INT_INF
    t_src = t[:, src]
    opt = (valid & (t_src < INT_INF)
           & edge_follows(pred, t_src, edges.t_start, edges.t_end)
           & (edges.t_end == t[:, dst]) & (dst[None, :] != sources[:, None]))

    bounds = bucket_bounds(windows, P)
    bv = torch.searchsorted(bounds, t.contiguous(), side="left").clamp(max=P - 1)
    bv = torch.where(reached, bv, P).reshape(-1)                   # [Q*V]

    # the optimal (row, edge) pairs as flat [Q*V] slots, grouped by bucket
    q, e = opt.nonzero(as_tuple=True)
    f_dst = q * V + dst[e]
    f_src = q * V + src[e]
    b = bv[f_dst]
    order = torch.argsort(b, stable=True)
    f_dst, f_src, b = f_dst[order], f_src[order], b[order]
    off = torch.searchsorted(b, torch.arange(P + 1, device=dev)).tolist()
    obs.count("host_reads")
    n_flat = Q * V
    not_source = torch.ones(n_flat, dtype=torch.bool, device=dev)
    not_source[rows * V + sources] = False
    assignable = reached.reshape(-1) & not_source

    # forward: sigma in bucket order
    sigma = torch.zeros(n_flat, dtype=torch.float32, device=dev)
    sigma[rows * V + sources] = 1.0
    for p in range(P):
        lo, hi = off[p], off[p + 1]
        contrib = torch.zeros(n_flat, dtype=torch.float32, device=dev)
        contrib.index_add_(0, f_dst[lo:hi], sigma[f_src[lo:hi]])
        if axis is not None:
            all_reduce(contrib, "sum", axis)
        sigma = torch.where(assignable & (bv == p), contrib, sigma)

    # backward: dependencies in reverse bucket order
    sigma_dst = sigma[f_dst]
    ratio = sigma[f_src] / torch.clamp(sigma_dst, min=1e-30)
    counts = sigma_dst > 0
    delta = torch.zeros(n_flat, dtype=torch.float32, device=dev)
    for p in range(P - 1, -1, -1):
        lo, hi = off[p], off[p + 1]
        w = ratio[lo:hi] * (1.0 + delta[f_dst[lo:hi]])
        add = torch.zeros(n_flat, dtype=torch.float32, device=dev)
        add.index_add_(0, f_src[lo:hi], torch.where(counts[lo:hi], w, 0.0))
        if axis is not None:
            all_reduce(add, "sum", axis)
        delta = delta + add
    delta = delta.reshape(Q, V)
    delta[rows, sources] = 0.0
    return delta


def temporal_betweenness_over_view(
    edges: EdgeView,
    windows,                        # [Q, 2]
    *,
    plan: AccessPlan,
    n_vertices: int,
    sources=None,                   # int (broadcast) | [Q] per-row
    pred: OrderingPredicateType = OrderingPredicateType.STRICTLY_SUCCEEDS,
    max_rounds: int = 0,
    n_buckets: int = 64,
    init=None,
) -> torch.Tensor:
    """delta[q, v] = dependency of v on sources[q] within windows[q], over a
    prebuilt (union-covering) view.  Summing rows that share a window gives
    classic BC (``temporal_betweenness``).  ``init`` must be None: the
    dependencies are a two-pass accumulation with no sound warm start.
    Under a plan with ``ladder > 0`` the EA upsweep runs through the
    frontier-rung ladder (bit-identical labels), and the Brandes passes
    are unchanged."""
    return _temporal_betweenness_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, sources=sources, pred=pred,
        max_rounds=max_rounds, n_buckets=n_buckets, init=init,
        ladder=ladder_eligible(plan))


def _temporal_betweenness_over_view(edges, windows, *, plan, n_vertices, sources=None,
                                    pred=OrderingPredicateType.STRICTLY_SUCCEEDS,
                                    max_rounds=0, n_buckets=64, init=None,
                                    ladder=False):
    """``ladder=False`` is the dense path of the callers the JAX package
    traces (``temporal_betweenness_batched``, ``sweep``, a serving
    advance)."""
    if init is not None:
        raise ValueError(
            "temporal_betweenness_over_view does not accept a warm init: "
            "Brandes dependencies are recomputed per run")
    runner = FixpointRunner.for_view(edges, windows=windows, sources=sources,
                                     plan=plan, n_vertices=n_vertices,
                                     max_rounds=max_rounds)
    if runner.sources is None:
        raise ValueError("temporal_betweenness_over_view needs sources=")
    t = _earliest_arrival_over_view(edges, runner.windows, sources=runner.sources,
                                    plan=plan, n_vertices=n_vertices, pred=pred,
                                    max_rounds=max_rounds, ladder=ladder)   # [Q, V]
    return _brandes_rows(edges, runner.valid, runner.windows, runner.sources, t,
                         n_buckets, pred, n_vertices, axis=plan.edge_axis)


def temporal_betweenness(
    g: TemporalGraph,
    sources,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.STRICTLY_SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
    n_buckets: int = 64,
) -> torch.Tensor:
    """BC[v] = sum over ``sources`` of the dependency of v (Brandes): the
    sources are the rows of ONE ``temporal_betweenness_over_view`` call."""
    plan = ensure_plan(plan)
    sources = torch.as_tensor(sources).reshape(-1)
    edges = view_for_plan(g, tger, window, plan)
    windows = np.tile(np.asarray([[int(window[0]), int(window[1])]], np.int32),
                      (sources.shape[0], 1))
    deltas = temporal_betweenness_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=g.n_vertices,
        pred=pred, max_rounds=max_rounds, n_buckets=n_buckets)
    return deltas.sum(dim=0)


def temporal_betweenness_batched(
    g: TemporalGraph,
    source,
    windows,                        # [W, 2] query windows
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.STRICTLY_SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
    n_buckets: int = 64,
) -> torch.Tensor:
    """delta[w, v] = the dependency rows of ONE source across W windows from
    a single union-window view."""
    plan = ensure_plan(plan)
    edges = view_for_plan(g, tger, union_window(windows), plan)
    return _temporal_betweenness_over_view(
        edges, windows, sources=source, plan=plan, n_vertices=g.n_vertices,
        pred=pred, max_rounds=max_rounds, n_buckets=n_buckets)


__all__ = [
    "temporal_betweenness",
    "temporal_betweenness_batched",
    "temporal_betweenness_over_view",
    "bucket_bounds",
]
