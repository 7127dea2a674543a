"""Edge views for the TemporalEdgeMap model (paper §4.4, Table 2).

The frontier is a dense boolean mask over vertices.  A view is the
candidate edge set one query relaxes over, built once per query by the
method its :class:`~repro_torch.engine.plan.AccessPlan` prescribes: the
whole graph (scan), a budgeted gather of the window's time-first range
(index), or light edges plus each heavy vertex's window range (hybrid).
All three give the same fixpoint; they differ only in work.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import (
    TGERIndex,
    gather_window_edges,
    vertex_range,
    window_range,
)
from repro_torch.device import resolve_device, to_numpy
from repro_torch.engine.plan import AccessPlan, make_plan
from repro_torch.kernels.temporal_edgemap import INT_INF


class EdgeView(NamedTuple):
    """A (possibly gathered) set of candidate temporal edges."""

    src: torch.Tensor      # i32[K]
    dst: torch.Tensor      # i32[K]
    t_start: torch.Tensor  # i32[K]
    t_end: torch.Tensor    # i32[K]
    weight: torch.Tensor   # f32[K]
    mask: torch.Tensor     # bool[K] — structural validity (gather padding)


def _gather(g: TemporalGraph, eids: torch.Tensor, mask: torch.Tensor) -> EdgeView:
    eids = eids.long()
    return EdgeView(g.src[eids], g.dst[eids], g.t_start[eids], g.t_end[eids],
                    g.weight[eids], mask)


def scan_view(g: TemporalGraph) -> EdgeView:
    return EdgeView(g.src, g.dst, g.t_start, g.t_end, g.weight,
                    torch.ones(g.n_edges, dtype=torch.bool, device=g.device))


def index_view(g: TemporalGraph, idx: TGERIndex, window, budget: int) -> EdgeView:
    """The <= budget edges whose start lies in the window, gathered through
    the global time-first permutation."""
    lo, hi = window_range(idx, window[0], window[1])
    eids, pos = gather_window_edges(idx, lo, budget)
    return _gather(g, eids, pos < hi)


def hybrid_view(g: TemporalGraph, idx: TGERIndex, window,
                per_vertex_budget: int) -> EdgeView:
    """Heavy/light per-vertex-class access (paper §5 at vertex granularity):
    light edges (sources below the indexing cutoff) are scanned; each heavy
    vertex contributes its window range, found by bisection in its
    start-sorted T-CSR slice and gathered under ``per_vertex_budget``."""
    dev = g.device
    le = idx.light_eids
    l_mask = torch.arange(le.shape[0], device=dev) < idx.n_light_edges
    light = _gather(g, le, l_mask)

    hv = idx.indexed_ids.clamp(min=0)                               # [H]
    lo, hi = vertex_range(g, hv, int(window[0]), int(window[1]))    # [H], [H]
    pos = lo[:, None] + torch.arange(per_vertex_budget, device=dev)[None, :]
    h_mask = (pos < hi[:, None]) & (idx.indexed_ids >= 0)[:, None]
    pos_c = pos.clamp(max=g.n_edges - 1).reshape(-1)
    heavy = _gather(g, pos_c, h_mask.reshape(-1))
    return EdgeView(*[torch.cat([l, h]) for l, h in zip(light, heavy)])


def ensure_plan(plan: Optional[AccessPlan]) -> AccessPlan:
    """``plan=None`` means the default full-scan plan on xla_segment."""
    return plan if plan is not None else make_plan("scan")


def view_for_plan(g: TemporalGraph, tger: Optional[TGERIndex], window,
                  plan: AccessPlan) -> EdgeView:
    """Build the candidate-edge view the plan's method prescribes."""
    if plan.method == "index":
        if tger is None or plan.budget <= 0:
            raise ValueError("index access requires a TGER and a positive budget")
        return index_view(g, tger, window, plan.budget)
    if plan.method == "hybrid":
        if tger is None or plan.per_vertex_budget <= 0:
            raise ValueError("hybrid access requires a TGER and a per-vertex budget")
        return hybrid_view(g, tger, window, plan.per_vertex_budget)
    return scan_view(g)


def _endpoints(edges: EdgeView, direction: str):
    if direction == "out":
        return edges.src, edges.dst
    if direction == "in":
        return edges.dst, edges.src
    raise ValueError(direction)


def union_window(windows) -> Tuple[int, int]:
    """The hull [min t0, max t1] of a [W, 2] window batch, on the host."""
    w = to_numpy(windows).reshape(-1, 2)
    return int(w[:, 0].min()), int(w[:, 1].max())


def frontier_from_sources(n_vertices: int, sources, device=None) -> torch.Tensor:
    """bool[V] frontier holding ``sources``; on the CUDA card unless
    ``device`` is given, like the other entry points."""
    device = resolve_device(device)
    f = torch.zeros(n_vertices, dtype=torch.bool, device=device)
    f[torch.as_tensor(sources, device=device).long()] = True
    return f


__all__ = [
    "EdgeView",
    "scan_view",
    "index_view",
    "hybrid_view",
    "ensure_plan",
    "view_for_plan",
    "union_window",
    "frontier_from_sources",
    "INT_INF",
]
