"""Temporal k-core: iterative peeling of vertices whose (undirected) degree
within the query window drops below k; plus the full coreness
decomposition.

Peeling is a fixpoint over the gather-once FixpointRunner's view and
window-validity mask.  The degrees are int32 sums into both endpoints, on
the segment path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.edgemap import EdgeView, ensure_plan, union_window, view_for_plan
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex
from repro_torch.engine.backends import segment_combine, segment_combine_windows
from repro_torch.engine.fixpoint import FixpointRunner
from repro_torch.engine.frontier import (
    LadderSpec,
    companion_for_view,
    ladder_eligible,
    rowwise_combine,
    run_laddered,
    sparse_window_valid,
)
from repro_torch.engine.plan import AccessPlan


def _live_degree(runner: FixpointRunner, alive):
    """Each vertex's degree over the valid edges with both endpoints alive
    ([V] or [Q, V])."""
    src, dst = runner.hoisted("endpoints", lambda: (runner.edges.src.long(),
                                                    runner.edges.dst.long()))
    V = runner.n_vertices
    if runner.batched:
        ones = (runner.valid & alive[:, src] & alive[:, dst]).to(torch.int32)
        return (segment_combine_windows(ones, dst, V, "sum")
                + segment_combine_windows(ones, src, V, "sum"))
    ones = (runner.valid & alive[src] & alive[dst]).to(torch.int32)
    return segment_combine(ones, dst, V, "sum") + segment_combine(ones, src, V, "sum")


def _peel_round(runner: FixpointRunner, k: int):
    """State ``(alive, changed)``: drop the alive vertices whose live
    degree is below ``k``."""

    def body(state, rnd=None):
        alive, _ = state
        new_alive = alive & (_live_degree(runner, alive) >= k)
        return new_alive, (new_alive != alive).any()

    return body


def _kcore_dense_round(runner, state, rnd):
    # the bit-identity anchor: degrees recounted from scratch as the dense
    # body does; (deg, died) are rebuilt so that a following sparse segment
    # delta-updates from a consistent pair
    alive, _, _, k = state
    deg = _live_degree(runner, alive)
    new_alive = alive & (deg >= k)
    return new_alive, deg, alive & ~new_alive, k


def _kcore_sparse_round(runner, gathered, state, rnd):
    # Frontier = the vertices that died LAST round: subtract their incident
    # live edges (by-source companion: the destination endpoints; by-dst:
    # the source endpoints), then peel on the repaired degrees.  An edge
    # whose far endpoint is already dead subtracts from a dead vertex,
    # whose degree is never read again, so every live degree matches the
    # dense recount and the peeling sequence is bit-identical.
    alive, deg, _, k = state
    edges, windows, V = runner.edges, runner.windows, runner.n_vertices
    (s_slots, s_cov), (d_slots, d_cov) = gathered
    ok_s, _, _ = sparse_window_valid(edges, windows, s_slots, s_cov)
    ok_d, _, _ = sparse_window_valid(edges, windows, d_slots, d_cov)
    ones = torch.ones(s_slots.shape, dtype=torch.int32, device=deg.device)
    deg = deg - rowwise_combine(ones, edges.dst[s_slots], V, "sum", ok_s)
    deg = deg - rowwise_combine(ones, edges.src[d_slots], V, "sum", ok_d)
    new_alive = alive & (deg >= k)
    return new_alive, deg, alive & ~new_alive, k


_KCORE_SPEC = LadderSpec("kcore", _kcore_dense_round, _kcore_sparse_round,
                         lambda s: s[2])


def _changed(state):
    return state[1]


def temporal_kcore(
    g: TemporalGraph,
    k,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
) -> torch.Tensor:
    """alive[V] bool: membership of the temporal k-core within the window."""
    runner = FixpointRunner.for_query(g, tger, window, plan=ensure_plan(plan),
                                      max_rounds=max_rounds)
    alive0 = torch.ones(g.n_vertices, dtype=torch.bool, device=g.device)
    alive, _ = runner.run(_changed, _peel_round(runner, int(k)), (alive0, True))
    return alive


def temporal_kcore_over_view(
    edges: EdgeView,
    windows,                        # [Q, 2]
    *,
    plan: AccessPlan,
    n_vertices: int,
    k,
    sources=None,                   # accepted for signature uniformity: must be None
    max_rounds: int = 0,
    init=None,
) -> torch.Tensor:
    """Batched k-core peeling over a prebuilt (union-covering) view:
    alive[q, v] = membership of the temporal k-core within windows[q]; ``k``
    is shared by all rows.  Source-free.

    ``init`` must be None: peeling only removes vertices, so only the
    all-alive start is exact.  Under a plan with ``ladder > 0`` the
    frontier-rung ladder runs: the vertices that died last round are the
    frontier, and sparse rounds subtract only their incident edges instead
    of recounting every degree; ``k`` rides in the carried state."""
    return _temporal_kcore_over_view(edges, windows, plan=plan, n_vertices=n_vertices,
                                     k=k, sources=sources, max_rounds=max_rounds,
                                     init=init, ladder=ladder_eligible(plan))


def _temporal_kcore_over_view(edges, windows, *, plan, n_vertices, k, sources=None,
                              max_rounds=0, init=None, ladder=False):
    """``ladder=False`` is the dense path of the callers the JAX package
    traces (``temporal_kcore_batched``, ``sweep``, a serving advance)."""
    if sources is not None:
        raise ValueError("temporal_kcore is source-free: pass sources=None")
    if init is not None:
        raise ValueError(
            "temporal_kcore_over_view does not accept a warm init: peeling "
            "cannot resurrect vertices, so only the all-alive start is exact")
    runner = FixpointRunner.for_view(edges, windows=windows, plan=plan,
                                     n_vertices=n_vertices, max_rounds=max_rounds)
    Q = runner.windows.shape[0]
    alive0 = torch.ones((Q, n_vertices), dtype=torch.bool, device=runner.device)
    if ladder:
        # died0 all-true makes the first segment dense (its summed degree
        # is 2E', above the handoff cutoff), which rebuilds (deg, died)
        # before any sparse round runs
        state0 = (alive0, torch.zeros((Q, n_vertices), dtype=torch.int32,
                                      device=runner.device), alive0, int(k))
        comps = (companion_for_view(edges.src, n_vertices),
                 companion_for_view(edges.dst, n_vertices))
        (alive, _, _, _), _ = run_laddered(_KCORE_SPEC, runner, state0,
                                           companions=comps)
        return alive
    alive, _ = runner.run(_changed, _peel_round(runner, int(k)), (alive0, True))
    return alive


def temporal_kcore_batched(
    g: TemporalGraph,
    k,
    windows,                        # [W, 2] query windows
    tger: Optional[TGERIndex] = None,
    *,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
) -> torch.Tensor:
    """alive[w, v] over all W windows from ONE union-window view; row w
    equals ``temporal_kcore(g, k, windows[w], ...)`` under the same plan."""
    plan = ensure_plan(plan)
    edges = view_for_plan(g, tger, union_window(windows), plan)
    return _temporal_kcore_over_view(edges, windows, plan=plan,
                                     n_vertices=g.n_vertices, k=k,
                                     max_rounds=max_rounds)


def temporal_coreness(
    g: TemporalGraph,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    k_max: int = 64,
    plan: Optional[AccessPlan] = None,
) -> torch.Tensor:
    """core[v] = the largest k <= k_max such that v belongs to the temporal
    k-core within the window.  Each k peels on from the (k-1)-core's alive
    set (the k-core is a subset); once nothing is alive, every larger k
    leaves the result as it is, so the loop stops there."""
    runner = FixpointRunner.for_query(g, tger, window, plan=ensure_plan(plan))
    V = g.n_vertices
    alive = torch.ones(V, dtype=torch.bool, device=g.device)
    core = torch.zeros(V, dtype=torch.int32, device=g.device)
    for k in range(1, k_max + 1):
        peel = _peel_round(runner, k)
        changed = True
        while changed:
            alive, changed = peel((alive, None))
            changed = bool(changed)
        core = torch.where(alive, k, core)
        if not bool(alive.any()):
            break
    return core


__all__ = [
    "temporal_kcore",
    "temporal_kcore_batched",
    "temporal_kcore_over_view",
    "temporal_coreness",
]
