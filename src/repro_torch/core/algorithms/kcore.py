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
from repro_torch.engine.plan import AccessPlan


def _peel_round(runner: FixpointRunner, k: int):
    """State ``(alive, changed)``: drop the alive vertices whose live
    degree (edges with both endpoints alive) is below ``k``."""
    src, dst = runner.edges.src.long(), runner.edges.dst.long()
    V = runner.n_vertices

    def body(state, rnd=None):
        alive, _ = state
        if runner.batched:
            live = runner.valid & alive[:, src] & alive[:, dst]
            ones = live.to(torch.int32)
            deg = (segment_combine_windows(ones, dst, V, "sum")
                   + segment_combine_windows(ones, src, V, "sum"))
        else:
            live = runner.valid & alive[src] & alive[dst]
            ones = live.to(torch.int32)
            deg = (segment_combine(ones, dst, V, "sum")
                   + segment_combine(ones, src, V, "sum"))
        new_alive = alive & (deg >= k)
        return new_alive, (new_alive != alive).any()

    return body


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
    all-alive start is exact.  The frontier ladder is not in the port, so
    this is always the dense fixpoint."""
    if sources is not None:
        raise ValueError("temporal_kcore is source-free: pass sources=None")
    if init is not None:
        raise ValueError(
            "temporal_kcore_over_view does not accept a warm init: peeling "
            "cannot resurrect vertices, so only the all-alive start is exact")
    runner = FixpointRunner.for_view(edges, windows=windows, plan=plan,
                                     n_vertices=n_vertices, max_rounds=max_rounds)
    alive0 = torch.ones((runner.windows.shape[0], n_vertices), dtype=torch.bool,
                        device=runner.device)
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
    return temporal_kcore_over_view(edges, windows, plan=plan,
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
