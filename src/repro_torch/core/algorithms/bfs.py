"""Temporal BFS: minimum-hop temporal-respecting paths.

Round h keeps the earliest arrival reachable within <= h hops; a vertex's
hop count is the first round it becomes reachable.  Exact for min-hop
because each round's arrival is the min over all <= h-hop paths.

Both the single-window run and the batched [Q, V] rows execute on the
gather-once FixpointRunner: the min combine runs K1 on a tiled scan plan.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.edgemap import (
    INT_INF,
    EdgeView,
    ensure_plan,
    frontier_from_sources,
    union_window,
    view_for_plan,
)
from repro_torch.core.predicates import OrderingPredicateType, edge_follows
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex
from repro_torch.engine.fixpoint import FixpointRunner
from repro_torch.engine.plan import AccessPlan


def _bfs_relax(pred: OrderingPredicateType):
    def relax(edges, arr_src):
        return edges.t_end, edge_follows(pred, arr_src, edges.t_start, edges.t_end)

    return relax


def _bfs_round(runner: FixpointRunner, pred: OrderingPredicateType):
    """State ``(arrival, hops, frontier)``; hops are numbered by the round
    counter, so a row whose frontier emptied never updates again."""
    relax = _bfs_relax(pred)

    def body(state, rnd):
        arrival, hops, frontier = state
        cand, _ = runner.step(frontier, arrival, relax, "min")
        new_arrival = torch.minimum(arrival, cand)
        improved = new_arrival < arrival
        new_hops = torch.where(improved & (hops == INT_INF), rnd + 1, hops)
        return new_arrival, new_hops, improved

    return body


def _frontier_nonempty(state) -> torch.Tensor:
    return state[2].any()


def temporal_bfs(
    g: TemporalGraph,
    source,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
):
    """Returns (hops[V], arrival[V]); hops = INT_INF when unreachable."""
    runner = FixpointRunner.for_query(g, tger, window, plan=ensure_plan(plan),
                                      max_rounds=max_rounds)
    V = g.n_vertices
    seeds = torch.as_tensor(source, device=g.device).long()
    arrival0 = torch.full((V,), INT_INF, dtype=torch.int32, device=g.device)
    arrival0[seeds] = runner.window[0]
    hops0 = torch.full((V,), INT_INF, dtype=torch.int32, device=g.device)
    hops0[seeds] = 0
    frontier0 = frontier_from_sources(V, source, device=g.device)
    arrival, hops, _ = runner.run(_frontier_nonempty, _bfs_round(runner, pred),
                                  (arrival0, hops0, frontier0))
    return hops, arrival


def temporal_bfs_over_view(
    edges: EdgeView,
    windows,                        # [Q, 2]
    *,
    plan: AccessPlan,
    n_vertices: int,
    sources=None,                   # int (broadcast) | [Q] per-row
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    max_rounds: int = 0,
    init=None,
):
    """Batched min-hop BFS over a prebuilt (union-covering) view: row q
    solves ``(sources[q], windows[q])``.  Returns (hops[Q, V], arrival[Q, V]).

    ``init`` must be None: hop counts are round-indexed, so only a cold
    start numbers them exactly.  The frontier ladder is not in the port, so
    this is always the dense fixpoint."""
    if init is not None:
        raise ValueError(
            "temporal_bfs_over_view does not accept a warm init: hop "
            "counts are round-indexed and only exact from a cold start")
    runner = FixpointRunner.for_view(edges, windows=windows, sources=sources,
                                     plan=plan, n_vertices=n_vertices,
                                     max_rounds=max_rounds)
    arrival0 = runner.seeded(INT_INF, runner.windows[:, 0])
    hops0 = runner.seeded(INT_INF, 0)
    arrival, hops, _ = runner.run(_frontier_nonempty, _bfs_round(runner, pred),
                                  (arrival0, hops0, runner.source_frontier()))
    return hops, arrival


def temporal_bfs_batched(
    g: TemporalGraph,
    source,
    windows,                        # [W, 2] query windows
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
):
    """(hops[W, V], arrival[W, V]) for one scalar ``source`` over all W
    windows from ONE union-window view; row w equals
    ``temporal_bfs(g, source, windows[w], ...)`` under the same plan."""
    if np.ndim(source) != 0:
        raise ValueError(
            "temporal_bfs_batched takes a scalar source; use "
            "temporal_bfs_over_view(sources=[...]) for per-row sources")
    plan = ensure_plan(plan)
    edges = view_for_plan(g, tger, union_window(windows), plan)
    return temporal_bfs_over_view(edges, windows, sources=int(source), plan=plan,
                                  n_vertices=g.n_vertices, pred=pred,
                                  max_rounds=max_rounds)


__all__ = ["temporal_bfs", "temporal_bfs_batched", "temporal_bfs_over_view"]
