"""Temporal connected components: hash-min label propagation over the edges
valid inside the query window (weak connectivity over the temporal slice).

Label propagation is a fixpoint over the gather-once FixpointRunner's
hoisted view.  Each round pushes the min label both ways: the forward push
into ``dst`` is in the graph's native edge order, so it runs K1 on a tiled
scan plan through the runner's prepared segment ids; the backward push into
``src`` takes the segment path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.edgemap import EdgeView, ensure_plan, union_window, view_for_plan
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex
from repro_torch.engine.backends import (
    Segments,
    combine_for_plan,
    combine_windows_for_plan,
)
from repro_torch.engine.fixpoint import FixpointRunner
from repro_torch.engine.plan import AccessPlan


def _cc_round(runner: FixpointRunner):
    """State ``(labels, changed)``: one push each way, then one pointer
    jump ``labels[v] = labels[labels[v]]``."""
    edges, plan, V = runner.edges, runner.plan, runner.n_vertices
    src, dst = edges.src.long(), edges.dst.long()
    fwd_ids = runner.segments        # into dst, prepared once (tiled on scan)
    bwd_ids = Segments(src)          # into src: the segment path

    def body(state, rnd):
        labels, _ = state
        if runner.batched:
            fwd = combine_windows_for_plan(plan, labels[:, src], fwd_ids, V, "min",
                                           masks=runner.valid)
            bwd = combine_windows_for_plan(plan, labels[:, dst], bwd_ids, V, "min",
                                           masks=runner.valid)
            new = torch.minimum(labels, torch.minimum(fwd, bwd))
            new = torch.minimum(new, torch.gather(new, 1, new.long()))
        else:
            fwd = combine_for_plan(plan, labels[src], fwd_ids, V, "min",
                                   mask=runner.valid)
            bwd = combine_for_plan(plan, labels[dst], bwd_ids, V, "min",
                                   mask=runner.valid)
            new = torch.minimum(labels, torch.minimum(fwd, bwd))
            new = torch.minimum(new, new[new.long()])
        return new, (new != labels).any()

    return body


def _changed(state):
    return state[1]


def temporal_cc(
    g: TemporalGraph,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
) -> torch.Tensor:
    """labels[V]: component id = min vertex id in the component (vertices
    with no valid incident edge are singletons)."""
    runner = FixpointRunner.for_query(g, tger, window, plan=ensure_plan(plan),
                                      max_rounds=max_rounds)
    labels0 = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    labels, _ = runner.run(_changed, _cc_round(runner), (labels0, True))
    return labels


def temporal_cc_over_view(
    edges: EdgeView,
    windows,                        # [Q, 2]
    *,
    plan: AccessPlan,
    n_vertices: int,
    sources=None,                   # accepted for signature uniformity: must be None
    max_rounds: int = 0,
    init: Optional[torch.Tensor] = None,   # [Q, V] warm-start labels
) -> torch.Tensor:
    """Batched hash-min label propagation over a prebuilt (union-covering)
    view: labels[q, v] within windows[q].  Source-free.

    ``init`` warm-starts the labels; exact when every init label bounds its
    row's component minimum from above and is a vertex of the same
    component (e.g. the converged labels of a contained window).  The
    frontier ladder is not in the port, so this is always the dense
    fixpoint."""
    if sources is not None:
        raise ValueError("temporal_cc is source-free: pass sources=None")
    runner = FixpointRunner.for_view(edges, windows=windows, plan=plan,
                                     n_vertices=n_vertices, max_rounds=max_rounds)
    Q = runner.windows.shape[0]
    if init is None:
        labels0 = torch.arange(n_vertices, dtype=torch.int32,
                               device=runner.device).expand(Q, -1)
    else:
        labels0 = torch.as_tensor(init, dtype=torch.int32, device=runner.device)
    labels, _ = runner.run(_changed, _cc_round(runner), (labels0, True))
    return labels


def temporal_cc_batched(
    g: TemporalGraph,
    windows,                        # [W, 2] query windows
    tger: Optional[TGERIndex] = None,
    *,
    plan: Optional[AccessPlan] = None,
    max_rounds: int = 0,
) -> torch.Tensor:
    """labels[w, v] over all W windows from ONE union-window view; row w
    equals ``temporal_cc(g, windows[w], ...)`` under the same plan (a
    converged row rides the extra rounds as a no-op)."""
    plan = ensure_plan(plan)
    edges = view_for_plan(g, tger, union_window(windows), plan)
    return temporal_cc_over_view(edges, windows, plan=plan,
                                 n_vertices=g.n_vertices, max_rounds=max_rounds)


# "connected components" is the workload name, temporal_cc_batched the
# module-consistent one.
connected_components_batched = temporal_cc_batched

__all__ = [
    "temporal_cc",
    "temporal_cc_batched",
    "temporal_cc_over_view",
    "connected_components_batched",
]
