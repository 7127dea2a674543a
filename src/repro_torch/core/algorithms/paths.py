"""Temporal minimal-path algorithms (paper §2.3, §6): earliest arrival,
latest departure, fastest and shortest duration, over the gather-once
FixpointRunner.

``WRITEMIN`` becomes a plan-directed min-combine and the CAS'd frontier a
changed-mask.  The edge view is gathered once per query, before the loop.
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
from repro_torch.core.tger import TGERIndex, vertex_range
from repro_torch.engine.backends import segment_combine
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

INT_NEG_INF = -(2**31)


def bucket_bounds(windows: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """i32[Q, P] upper bounds of the P arrival buckets of each window: a
    uniform grid ``ta + int32(float32(tb - ta) * (p + 1) / P)`` in float32,
    rounded as the JAX package's compiled program rounds it (a bound one
    off re-buckets vertices).  XLA compiles the division by the constant P
    into a multiplication by P's float32 reciprocal, which differs from a
    true division unless P is a power of two; the port multiplies too."""
    ta, tb = windows[:, 0:1], windows[:, 1:2]
    steps = torch.arange(1, n_buckets + 1, dtype=torch.int32, device=windows.device)
    span = (tb - ta).to(torch.float32)
    recip = float(np.float32(1) / np.float32(n_buckets))   # exact in float32
    return ta + (span * steps * recip).to(torch.int32)


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
    frontier_trace: bool = False,
):
    """t[v] = earliest arrival time from ``source`` (a vertex, or a list of
    seed vertices) to v within [ta, tb]; INT_INF where unreachable.

    ``visit_once=True`` reproduces Alg. 2's CAS(Visited) literally; the
    default label-correcting variant makes every improved vertex the next
    frontier.  ``with_metrics=True`` returns ``(arrival, FixpointMetrics)``
    at the cost of one extra segment-sum per round; ``frontier_trace=True``
    (with metrics) also fills ``FixpointMetrics.frontier_trace`` with the
    per-round occupancy.  A single-window dense fixpoint, as the JAX
    package's (jitted) one: the ladder runs in ``*_over_view`` calls.
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
            _frontier_nonempty, lambda state, rnd: body(state), init,
            frontier_trace=frontier_trace)
        return arrival, metrics
    arrival, _, _ = runner.run(_frontier_nonempty,
                               lambda state, rnd: body(state)[0], init)
    return arrival


def earliest_arrival_multi(g, sources, window, tger=None, **kw):
    """Multi-source EA: one row per source, [S, V].  The JAX package vmaps
    ``earliest_arrival`` over the sources; here the sources are the batch
    axis of one dense batched run over the same window."""
    sources = torch.as_tensor(sources).reshape(-1)
    windows = np.tile(np.asarray([[int(window[0]), int(window[1])]], np.int32),
                      (sources.shape[0], 1))
    plan = ensure_plan(kw.pop("plan", None))
    edges = view_for_plan(g, tger, window, plan)
    return _earliest_arrival_over_view(edges, windows, plan=plan,
                                       n_vertices=g.n_vertices, sources=sources, **kw)


@functools.lru_cache(maxsize=None)
def _ea_ladder_spec(pred: OrderingPredicateType) -> LadderSpec:
    """EA's ladder contract: state ``(arrival, frontier)``, the
    label-correcting variant only (``visit_once`` stays dense)."""
    relax = _ea_relax(pred)

    def dense_round(runner, state, rnd):
        arrival, frontier = state
        cand, _ = runner.step(frontier, arrival, relax, "min")
        new_arrival = torch.minimum(arrival, cand)
        return new_arrival, new_arrival < arrival

    def sparse_round(runner, gathered, state, rnd):
        arrival, _ = state
        edges = runner.edges
        (slots, cov), = gathered
        ok, ts, te = sparse_window_valid(edges, runner.windows, slots, cov)
        ok &= edge_follows(pred, take_rows(arrival, edges.src[slots]), ts, te)
        out = rowwise_combine(te, edges.dst[slots], runner.n_vertices, "min", ok)
        new_arrival = torch.minimum(arrival, out)
        return new_arrival, new_arrival < arrival

    return LadderSpec("ea", dense_round, sparse_round, lambda s: s[1])


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
    ``with_rounds=True`` returns ``(arrival, rounds)``.

    Under a plan with ``ladder > 0`` the label-correcting variant runs the
    frontier-rung ladder (``engine/frontier.py``): bit-identical labels and
    round count, sparse tail rounds proportional to the live frontier.
    ``visit_once`` stays dense."""
    return _earliest_arrival_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, sources=sources,
        pred=pred, max_rounds=max_rounds, visit_once=visit_once, init=init,
        with_rounds=with_rounds, ladder=ladder_eligible(plan))


def _earliest_arrival_over_view(edges, windows, *, plan, n_vertices, sources=None,
                                pred=OrderingPredicateType.SUCCEEDS, max_rounds=0,
                                visit_once=False, init=None, with_rounds=False,
                                ladder=False):
    """``ladder=False`` is the dense path of the callers the JAX package
    traces (the batched entry points, ``sweep``, a serving advance)."""
    runner = FixpointRunner.for_view(edges, windows=windows, sources=sources,
                                     plan=plan, n_vertices=n_vertices,
                                     max_rounds=max_rounds)
    if init is None:
        arrival0 = runner.seeded(INT_INF, runner.windows[:, 0])
        frontier0 = runner.source_frontier()
    else:
        arrival0 = torch.as_tensor(init, dtype=torch.int32, device=runner.device)
        frontier0 = arrival0 < INT_INF
    if ladder and not visit_once:
        (arrival, _), rounds = run_laddered(
            _ea_ladder_spec(pred), runner, (arrival0, frontier0),
            companions=(companion_for_view(edges.src, n_vertices),))
    else:
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
    return _earliest_arrival_over_view(
        edges, windows, sources=int(source), plan=plan, n_vertices=g.n_vertices,
        pred=pred, max_rounds=max_rounds, visit_once=visit_once,
    )


# ---------------------------------------------------------------------------
# Latest departure
# ---------------------------------------------------------------------------

def latest_departure(
    g: TemporalGraph,
    target,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
) -> torch.Tensor:
    """ld[v] = latest time one can depart v and still reach ``target``
    within the window; INT_NEG_INF where it cannot.  EA's mirror on the
    in-direction with a max-combine (the segment path: the tile layout
    groups destinations, not sources)."""
    if pred is OrderingPredicateType.STRICTLY_SUCCEEDS:
        chains = torch.lt
    elif pred is OrderingPredicateType.SUCCEEDS:
        chains = torch.le
    else:
        raise ValueError("latest_departure supports succeeds predicates")
    runner = FixpointRunner.for_query(g, tger, window, plan=ensure_plan(plan),
                                      direction="in", max_rounds=max_rounds)
    V = g.n_vertices
    ld0 = torch.full((V,), INT_NEG_INF, dtype=torch.int32, device=g.device)
    ld0[torch.as_tensor(target, device=g.device).long()] = runner.window[1]
    frontier0 = frontier_from_sources(V, target, device=g.device)

    def relax(edges, ld_dst):
        # an edge (u, v, [ts, te]) chains before leaving v at ld[v]:
        # succeeds te <= ld[v], strictly succeeds te < ld[v]
        return edges.t_start, chains(edges.t_end, ld_dst)

    def body(state, rnd):
        ld, frontier = state
        cand, _ = runner.step(frontier, ld, relax, "max")
        new_ld = torch.maximum(ld, cand)
        return new_ld, new_ld > ld

    ld, _ = runner.run(_frontier_nonempty, body, (ld0, frontier0))
    return ld


# ---------------------------------------------------------------------------
# Fastest (min over departures d of EA(leave >= d) - d)
# ---------------------------------------------------------------------------

def fastest(
    g: TemporalGraph,
    source,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
    n_departures: int = 32,
) -> torch.Tensor:
    """f[v] = min elapsed time of any temporal path source -> v in the
    window (Wu et al.: min over departures t_d of EA([t_d, tb])[v] - t_d).
    The departures are the source's first ``n_departures`` out-edge starts
    inside the window (the per-vertex range query); repeats are dropped,
    and the ladder [(t_d, tb), ...] runs as ONE batched EA over one
    union-window view: on a tiled plan one K1 launch per round with the D
    departures on its grid y."""
    plan = ensure_plan(plan)
    ta, tb = int(window[0]), int(window[1])
    dev = g.device
    lo, hi = vertex_range(g, int(source), ta, tb)
    pos = lo + torch.arange(n_departures, dtype=torch.int64, device=dev)
    valid = pos < hi
    departs = torch.where(valid, g.t_start[pos.clamp(max=max(g.n_edges - 1, 0))],
                          tb).to(torch.int32)
    rep = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                     departs[1:] == departs[:-1]])
    valid &= ~rep
    windows = torch.stack([departs, torch.full_like(departs, tb)], dim=1)  # [D, 2]
    arr = earliest_arrival_batched(g, int(source), windows, tger, pred=pred,
                                   plan=plan, max_rounds=max_rounds)      # [D, V]
    durs = torch.where(arr == INT_INF, INT_INF, arr - departs[:, None])
    durs = torch.where(valid[:, None], durs, INT_INF)
    out = durs.min(dim=0).values
    out[int(source)] = 0
    return out


# ---------------------------------------------------------------------------
# Shortest duration (Pareto staircase over arrival buckets)
# ---------------------------------------------------------------------------

def shortest_duration(
    g: TemporalGraph,
    source,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
    n_buckets: int = 64,
    use_weights: bool = False,
) -> torch.Tensor:
    """d[v] = min summed traversal time (or edge weight, with
    ``use_weights``) over temporal paths source -> v in the window.

    State is a monotone Pareto staircase dur[v, p] = best cost among paths
    arriving no later than bound[p]: exact when the distinct event times
    fit in ``n_buckets``, otherwise sound with bucket-resolution
    completeness.  The buckets of each edge (arrival ``q``, usable source
    bucket ``p_src``) are loop-invariant and computed once."""
    plan = ensure_plan(plan)
    runner = FixpointRunner.for_query(g, tger, window, plan=plan,
                                      max_rounds=max_rounds)
    edges, base_valid = runner.edges, runner.valid
    V, P = g.n_vertices, n_buckets
    dev = g.device
    source = int(source)
    ta, tb = runner.window
    bounds = bucket_bounds(torch.tensor([[ta, tb]], dtype=torch.int32, device=dev),
                           P)[0].contiguous()

    dur0 = torch.full((V, P), float("inf"), dtype=torch.float32, device=dev)
    dur0[source] = 0.0
    frontier0 = frontier_from_sources(V, source, device=dev)
    cost = (edges.weight if use_weights
            else (edges.t_end - edges.t_start).to(torch.float32))
    # arrival bucket of each edge's end: the first p with bound[p] >= te
    q = torch.searchsorted(bounds, edges.t_end.contiguous()).clamp(max=P - 1)
    # usable source bucket: the last p with bound[p] <= ts (strict: ts - 1);
    # p_src = -1 edges are usable only from the source, whose staircase is 0
    ts_bound = (edges.t_start - 1 if pred is OrderingPredicateType.STRICTLY_SUCCEEDS
                else edges.t_start)
    p_src = torch.searchsorted(bounds, ts_bound.contiguous(), right=True) - 1
    src = edges.src.long()
    from_source = src == source
    src_ok = (p_src >= 0) | from_source
    p_src_c = p_src.clamp(min=0)
    flat_ids = edges.dst.long() * P + q

    def body(state, rnd):
        dur, frontier = state
        usable = base_valid & frontier[src] & src_ok
        cand = torch.where(from_source, 0.0, dur[src, p_src_c]) + cost
        upd = segment_combine(cand, flat_ids, V * P, "min", mask=usable,
                              axis=plan.edge_axis)
        new_dur = torch.cummin(torch.minimum(dur, upd.view(V, P)), dim=1).values
        return new_dur, (new_dur < dur).any(dim=1)

    dur, _ = runner.run(_frontier_nonempty, body, (dur0, frontier0))
    return dur[:, P - 1].contiguous()


__all__ = [
    "earliest_arrival",
    "earliest_arrival_multi",
    "earliest_arrival_over_view",
    "earliest_arrival_batched",
    "latest_departure",
    "fastest",
    "shortest_duration",
]
