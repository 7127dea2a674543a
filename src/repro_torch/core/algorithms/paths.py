"""Earliest arrival (paper Algorithm 2) over the gather-once FixpointRunner.

``WRITEMIN`` becomes a plan-directed min-combine and the CAS'd frontier a
changed-mask.  The edge view is gathered once per query, before the loop.
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


def _ea_relax(pred: OrderingPredicateType):
    def relax(edges, arr_src):
        ok = edge_follows(pred, arr_src, edges.t_start, edges.t_end)
        return edges.t_end, ok

    return relax


def _ea_round(runner: FixpointRunner, relax, visit_once: bool,
              touched: bool = False):
    """The body of every EA fixpoint: relax, min into the labels, and make
    the improved vertices the next frontier."""

    def body(state):
        arrival, frontier, visited = state
        cand, touched_v = runner.step(frontier, arrival, relax, "min",
                                      compute_touched=touched)
        new_arrival = torch.minimum(arrival, cand)
        improved = new_arrival < arrival
        if visit_once:
            new_frontier = improved & ~visited
            visited = visited | improved
        else:
            new_frontier = improved
        return (new_arrival, new_frontier, visited), touched_v

    return body


def _frontier_nonempty(state) -> torch.Tensor:
    return state[1].any()


def earliest_arrival(
    g: TemporalGraph,
    source,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
    visit_once: bool = False,
    with_metrics: bool = False,
):
    """t[v] = earliest arrival time from ``source`` (a vertex, or a list of
    seed vertices) to v within [ta, tb]; INT_INF where unreachable.

    ``visit_once=True`` reproduces Alg. 2's CAS(Visited) literally; the
    default label-correcting variant makes every improved vertex the next
    frontier.  ``with_metrics=True`` returns ``(arrival, FixpointMetrics)``
    at the cost of one extra segment-sum per round.
    """
    runner = FixpointRunner.for_query(g, tger, window, plan=ensure_plan(plan),
                                      max_rounds=max_rounds)
    V = g.n_vertices
    arrival0 = torch.full((V,), INT_INF, dtype=torch.int32, device=g.device)
    arrival0[torch.as_tensor(source, device=g.device).long()] = runner.window[0]
    frontier0 = frontier_from_sources(V, source, device=g.device)
    body = _ea_round(runner, _ea_relax(pred), visit_once, touched=with_metrics)
    init = (arrival0, frontier0, frontier0)
    if with_metrics:
        (arrival, _, _), metrics = runner.run_with_metrics(
            _frontier_nonempty, lambda state, rnd: body(state), init)
        return arrival, metrics
    arrival, _, _ = runner.run(_frontier_nonempty,
                               lambda state, rnd: body(state)[0], init)
    return arrival


def earliest_arrival_multi(g, sources, window, tger=None, **kw):
    """Multi-source EA: one row per source, [S, V].  The JAX package vmaps
    ``earliest_arrival`` over the sources; here the sources are the batch
    axis of one batched run over the same window."""
    sources = torch.as_tensor(sources).reshape(-1)
    windows = np.tile(np.asarray([[int(window[0]), int(window[1])]], np.int32),
                      (sources.shape[0], 1))
    plan = ensure_plan(kw.pop("plan", None))
    edges = view_for_plan(g, tger, window, plan)
    return earliest_arrival_over_view(edges, windows, plan=plan,
                                      n_vertices=g.n_vertices, sources=sources,
                                      **kw)


def earliest_arrival_over_view(
    edges: EdgeView,
    windows,                        # [Q, 2]
    *,
    plan: AccessPlan,
    n_vertices: int,
    sources=None,                   # int (broadcast) | [Q] per-row
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    max_rounds: int = 0,
    visit_once: bool = False,
    init: Optional[torch.Tensor] = None,   # [Q, V] warm-start arrival
    with_rounds: bool = False,
):
    """The batched EA fixpoint over a prebuilt (union-covering) view: row q
    solves ``(sources[q], windows[q])``; a scalar source broadcasts.
    ``init`` warm-starts with [Q, V] labels (frontier = the finite labels);
    ``with_rounds=True`` returns ``(arrival, rounds)``."""
    runner = FixpointRunner.for_view(edges, windows=windows, sources=sources,
                                     plan=plan, n_vertices=n_vertices,
                                     max_rounds=max_rounds)
    if init is None:
        arrival0 = runner.seeded(INT_INF, runner.windows[:, 0])
        frontier0 = runner.source_frontier()
    else:
        arrival0 = torch.as_tensor(init, dtype=torch.int32, device=runner.device)
        frontier0 = arrival0 < INT_INF
    body = _ea_round(runner, _ea_relax(pred), visit_once)
    (arrival, _, _), rounds = runner.run(
        _frontier_nonempty, lambda state, rnd: body(state)[0],
        (arrival0, frontier0, frontier0), with_rounds=True)
    return (arrival, rounds) if with_rounds else arrival


def earliest_arrival_batched(
    g: TemporalGraph,
    source,
    windows,                        # [W, 2] query windows
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
    visit_once: bool = False,
) -> torch.Tensor:
    """Batched multi-window EA: arrival[w, v] from one scalar ``source``
    within windows[w], for all W windows over ONE union-window view.  Row w
    equals ``earliest_arrival(g, source, windows[w], ...)`` under the same
    (union-budgeted) plan."""
    if np.ndim(source) != 0:
        raise ValueError(
            "earliest_arrival_batched takes a scalar source; use "
            "earliest_arrival_over_view(sources=[...]) for per-row sources "
            "or earliest_arrival(g, [s1, s2, ...], ...) for a multi-seed "
            "single query")
    plan = ensure_plan(plan)
    edges = view_for_plan(g, tger, union_window(windows), plan)
    return earliest_arrival_over_view(
        edges, windows, sources=int(source), plan=plan, n_vertices=g.n_vertices,
        pred=pred, max_rounds=max_rounds, visit_once=visit_once,
    )


__all__ = [
    "earliest_arrival",
    "earliest_arrival_multi",
    "earliest_arrival_over_view",
    "earliest_arrival_batched",
]
