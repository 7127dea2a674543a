"""Temporal BFS: minimum-hop temporal-respecting paths.

Round h keeps the earliest arrival reachable within <= h hops; a vertex's
hop count is the first round it becomes reachable.  Exact for min-hop
because each round's arrival is the min over all <= h-hop paths.

Both the single-window run and the batched [Q, V] rows execute on the
gather-once FixpointRunner: the min combine runs K1 on a tiled scan plan.
"""
from __future__ import annotations

import functools
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
from repro_torch.engine.frontier import (
    LadderSpec,
    companion_for_view,
    ladder_eligible,
    rowwise_combine,
    run_laddered,
    sparse_window_valid,
    take_rows,
)
from repro_torch.engine.plan import AccessPlan


def _bfs_relax(pred: OrderingPredicateType):
    def relax(edges, arr_src):
        return edges.t_end, edge_follows(pred, arr_src, edges.t_start, edges.t_end)

    return relax


def _bfs_update(arrival, hops, cand, rnd):
    """Min the candidates into the labels; a vertex's hop count is the
    first round its arrival improves, so a row whose frontier emptied never
    updates again."""
    new_arrival = torch.minimum(arrival, cand)
    improved = new_arrival < arrival
    new_hops = torch.where(improved & (hops == INT_INF), rnd + 1, hops)
    return new_arrival, new_hops, improved


def _bfs_round(runner: FixpointRunner, pred: OrderingPredicateType):
    """State ``(arrival, hops, frontier)``."""
    relax = _bfs_relax(pred)

    def body(state, rnd):
        arrival, hops, frontier = state
        cand, _ = runner.step(frontier, arrival, relax, "min")
        return _bfs_update(arrival, hops, cand, rnd)

    return body


@functools.lru_cache(maxsize=None)
def _bfs_ladder_spec(pred: OrderingPredicateType) -> LadderSpec:
    """BFS's ladder contract, state ``(arrival, hops, frontier)``: hops are
    numbered by the ladder's GLOBAL round counter, so laddered hop counts
    equal the dense numbering exactly."""

    def dense_round(runner, state, rnd):
        return runner.hoisted(("bfs_round", pred),
                              lambda: _bfs_round(runner, pred))(state, rnd)

    def sparse_round(runner, gathered, state, rnd):
        arrival, hops, _ = state
        edges = runner.edges
        (slots, cov), = gathered
        ok, ts, te = sparse_window_valid(edges, runner.windows, slots, cov)
        ok &= edge_follows(pred, take_rows(arrival, edges.src[slots]), ts, te)
        cand = rowwise_combine(te, edges.dst[slots], runner.n_vertices, "min", ok)
        return _bfs_update(arrival, hops, cand, rnd)

    return LadderSpec("bfs", dense_round, sparse_round, lambda s: s[2])


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
    start numbers them exactly.  Under a plan with ``ladder > 0`` the
    frontier-rung ladder runs, bit-identical hop counts included."""
    return _temporal_bfs_over_view(edges, windows, plan=plan, n_vertices=n_vertices,
                                   sources=sources, pred=pred, max_rounds=max_rounds,
                                   init=init, ladder=ladder_eligible(plan))


def _temporal_bfs_over_view(edges, windows, *, plan, n_vertices, sources=None,
                            pred=OrderingPredicateType.SUCCEEDS, max_rounds=0,
                            init=None, ladder=False):
    """``ladder=False`` is the dense path of the callers the JAX package
    traces (``temporal_bfs_batched``, ``sweep``, a serving advance)."""
    if init is not None:
        raise ValueError(
            "temporal_bfs_over_view does not accept a warm init: hop "
            "counts are round-indexed and only exact from a cold start")
    runner = FixpointRunner.for_view(edges, windows=windows, sources=sources,
                                     plan=plan, n_vertices=n_vertices,
                                     max_rounds=max_rounds)
    state0 = (runner.seeded(INT_INF, runner.windows[:, 0]), runner.seeded(INT_INF, 0),
              runner.source_frontier())
    if ladder:
        (arrival, hops, _), _ = run_laddered(
            _bfs_ladder_spec(pred), runner, state0,
            companions=(companion_for_view(edges.src, n_vertices),))
    else:
        arrival, hops, _ = runner.run(_frontier_nonempty, _bfs_round(runner, pred),
                                      state0)
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
    return _temporal_bfs_over_view(edges, windows, sources=int(source), plan=plan,
                                   n_vertices=g.n_vertices, pred=pred,
                                   max_rounds=max_rounds, ladder=False)


__all__ = ["temporal_bfs", "temporal_bfs_batched", "temporal_bfs_over_view"]
