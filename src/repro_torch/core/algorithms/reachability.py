"""Time-constrained reachability under the OVERLAPS ordering predicate
(paper Table 1: influence propagation / information cascades).

Overlaps chains require start(A) <= start(B) and end(A) <= end(B) for
consecutive edges, so the per-vertex state is the (start, end) of the last
edge on the path.  Each vertex keeps the lexicographically minimal
(end, start) pair, found by a two-pass segment min (min end, then min start
among the edges achieving it).  This is sound (every reported vertex is
overlaps-reachable) and exact whenever minimizing the end never sacrifices
a needed start; the exhaustive Pareto oracle is the JAX package's
``core/reference.py``.

Execution rides the gather-once FixpointRunner's view and validity mask.
The JAX package vmaps a per-row while loop; here all rows relax together in
one host loop until no row changes.  A row whose frontier emptied relaxes
no edge, so its state stays put and each row equals its own loop's result.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.edgemap import INT_INF, EdgeView, ensure_plan, union_window, view_for_plan
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex
from repro_torch.engine.backends import segment_combine_windows
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


def _reach_update(te, ts, dst, s_end, s_start, ok, combine):
    """The two-pass lexicographic min over [Q, K] edge rows: min end per
    destination, then min start among the edges achieving it.
    ``combine(vals, ids, mask)`` is the dense or the sparse row-wise
    segment min; both minimize over the same valid multiset."""
    min_end = combine(te, dst, ok)
    achieves = ok & (te == take_rows(min_end, dst))
    min_start = combine(ts, dst, achieves)
    better = (min_end < s_end) | ((min_end == s_end) & (min_start < s_start))
    return (torch.where(better, min_end, s_end),
            torch.where(better, min_start, s_start), better)


def _reach_round(runner: FixpointRunner):
    """State ``(last_end, last_start, frontier)`` of [Q, V] rows; both
    segment mins take the segment path."""
    edges, V = runner.edges, runner.n_vertices
    src, dst = edges.src.long(), edges.dst.long()
    ts, te = edges.t_start, edges.t_end
    valid = runner.valid if runner.batched else runner.valid[None, :]

    def combine(vals, ids, mask):
        return segment_combine_windows(vals, ids[0], V, "min", masks=mask)

    def body(state, rnd):
        s_end, s_start, frontier = state
        pe, ps = s_end[:, src], s_start[:, src]
        ok = valid & frontier[:, src] & (pe < INT_INF) & (ps <= ts) & (pe <= te)
        return _reach_update(te.expand_as(ok), ts.expand_as(ok), dst.expand_as(ok),
                             s_end, s_start, ok, combine)

    return body


def _reach_sparse_round(runner, gathered, state, rnd):
    s_end, s_start, _ = state
    edges = runner.edges
    (slots, cov), = gathered
    ok, ts, te = sparse_window_valid(edges, runner.windows, slots, cov)
    src_at = edges.src[slots]
    pe, ps = take_rows(s_end, src_at), take_rows(s_start, src_at)
    ok &= (pe < INT_INF) & (ps <= ts) & (pe <= te)

    def combine(vals, ids, mask):
        return rowwise_combine(vals, ids, runner.n_vertices, "min", mask)

    return _reach_update(te, ts, edges.dst[slots], s_end, s_start, ok, combine)


def _reach_dense_round(runner, state, rnd):
    return runner.hoisted("reach_round", lambda: _reach_round(runner))(state, rnd)


_REACH_SPEC = LadderSpec("reach", _reach_dense_round, _reach_sparse_round,
                         lambda s: s[2])


def _solve_rows(runner: FixpointRunner, end0, start0, frontier0, ladder=False):
    """The overlaps fixpoint over the runner's view for [Q, V] rows, dense
    or (batched, ``ladder``) through the frontier-rung ladder."""
    if ladder:
        comp = companion_for_view(runner.edges.src, runner.n_vertices)
        (s_end, s_start, _), _ = run_laddered(_REACH_SPEC, runner,
                                              (end0, start0, frontier0),
                                              companions=(comp,))
    else:
        s_end, s_start, _ = runner.run(lambda state: state[2].any(), _reach_round(runner),
                                       (end0, start0, frontier0))
    reachable = s_end < INT_INF
    return (reachable, torch.where(reachable, s_start, 0),
            torch.where(reachable, s_end, 0))


def overlaps_reachability(
    g: TemporalGraph,
    source,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
):
    """Returns (reachable[V] bool, last_start[V], last_end[V])."""
    runner = FixpointRunner.for_query(g, tger, window, plan=ensure_plan(plan),
                                      max_rounds=max_rounds)
    V = g.n_vertices
    seeds = torch.as_tensor(source, device=g.device).long()
    # the source seeds with (ta, ta): its first edge only needs ts >= ta and
    # te >= ta, which the window implies
    end0 = torch.full((1, V), INT_INF, dtype=torch.int32, device=g.device)
    end0[0, seeds] = runner.window[0]
    frontier0 = torch.zeros((1, V), dtype=torch.bool, device=g.device)
    frontier0[0, seeds] = True
    return tuple(r[0] for r in _solve_rows(runner, end0, end0.clone(), frontier0))


def overlaps_reachability_over_view(
    edges: EdgeView,
    windows,                        # [Q, 2]
    *,
    plan: AccessPlan,
    n_vertices: int,
    sources=None,                   # int (broadcast) | [Q] per-row
    max_rounds: int = 0,
    init=None,                      # optional ([Q, V] end, [Q, V] start)
):
    """Batched overlaps fixpoints over a prebuilt (union-covering) view: row
    q solves ``(sources[q], windows[q])``.  ``init`` warm-starts
    ``(last_end, last_start)``, sound when every finite pair is the last
    edge of a real overlaps chain inside the row's window.  Under a plan
    with ``ladder > 0`` the frontier-rung ladder runs, the two-pass
    lexicographic min evaluated on the gathered frontier slots only."""
    return _overlaps_reachability_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, sources=sources,
        max_rounds=max_rounds, init=init, ladder=ladder_eligible(plan))


def _overlaps_reachability_over_view(edges, windows, *, plan, n_vertices, sources=None,
                                     max_rounds=0, init=None, ladder=False):
    """``ladder=False`` is the dense path of the callers the JAX package
    traces (``overlaps_reachability_batched``, ``sweep``, a serving
    advance)."""
    runner = FixpointRunner.for_view(edges, windows=windows, sources=sources,
                                     plan=plan, n_vertices=n_vertices,
                                     max_rounds=max_rounds)
    if runner.sources is None:
        raise ValueError("overlaps_reachability_over_view needs sources=")
    if init is None:
        end0 = runner.seeded(INT_INF, runner.windows[:, 0])
        start0 = end0.clone()
        frontier0 = runner.source_frontier()
    else:
        end0 = torch.as_tensor(init[0], dtype=torch.int32, device=runner.device)
        start0 = torch.as_tensor(init[1], dtype=torch.int32, device=runner.device)
        frontier0 = end0 < INT_INF
    return _solve_rows(runner, end0, start0, frontier0, ladder=ladder)


def overlaps_reachability_batched(
    g: TemporalGraph,
    source,
    windows,                        # [W, 2] query windows
    tger: Optional[TGERIndex] = None,
    *,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
):
    """(reachable[W, V], last_start[W, V], last_end[W, V]) over ONE
    union-window view; row w equals the single-window run on windows[w]."""
    plan = ensure_plan(plan)
    edges = view_for_plan(g, tger, union_window(windows), plan)
    return _overlaps_reachability_over_view(edges, windows, sources=source,
                                            plan=plan, n_vertices=g.n_vertices,
                                            max_rounds=max_rounds)


__all__ = [
    "overlaps_reachability",
    "overlaps_reachability_batched",
    "overlaps_reachability_over_view",
]
