"""TemporalEdgeMap / VertexMap: the Ligra-style programming model extended
to time (paper §4.4, Table 2), and the edge views it runs over.

The frontier is a dense boolean mask over vertices.  A view is the
candidate edge set one query relaxes over, built once per query by the
method its :class:`~repro_torch.engine.plan.AccessPlan` prescribes: the
whole graph (scan), a budgeted gather of the window's time-first range
(index), or light edges plus each heavy vertex's window range (hybrid).
All three give the same fixpoint; they differ only in work.

``temporal_edge_map`` is one relaxation round under a plan: a min-combine
into destinations over a scan view on ``pallas_tiled`` runs K1, every
other combine the masked segment path.  ``temporal_edge_map_batched``
serves W windows from ONE view over their union (one K1 launch for all W
on a tiled scan plan).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.predicates import OrderingPredicateType, in_window
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import (
    TGERIndex,
    gather_window_edges,
    heavy_window_positions_host,
    vertex_range,
    window_positions_host,
    window_range,
)
from repro_torch.device import resolve_device, to_numpy
from repro_torch.engine.backends import (  # noqa: F401 (re-export)
    combine_for_plan,
    combine_windows_for_plan,
    segment_combine,
    segment_combine_windows,
)
from repro_torch.engine.frontier import (  # noqa: F401 (re-export)
    FrontierView,
    advance_frontier_view,
    build_frontier_view,
    companion_for_view,
)
from repro_torch.engine.plan import AccessPlan, make_plan, per_vertex_window_budget, rung
from repro_torch.kernels.temporal_edgemap import INT_INF

FLOAT_INF = float("inf")


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


def hybrid_budget(g: TemporalGraph, idx: TGERIndex, window, floor: int = 16) -> int:
    """Static per-vertex budget guaranteeing ``hybrid_view`` completeness:
    the planner's ``per_vertex_window_budget``."""
    return per_vertex_window_budget(g, idx, (int(window[0]), int(window[1])),
                                    floor=floor)


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


# ---------------------------------------------------------------------------
# Ring-buffer views
#
# The incremental server needs a view that is POSITIONALLY STABLE across
# advances: the slot an edge occupies does not depend on the current
# window, so a forward slide touches only the entering positions.  The
# identity is ``slot(p) = p mod C`` over the time-first permutation (global
# for index plans; heavy-only for hybrid plans, whose light partition is a
# window-independent prefix).  An advance from ``lo`` to ``lo'`` writes
# exactly the entering positions [lo + C, lo' + C) into the slots they own,
# in place, and recomputes the O(C) validity mask; every surviving slot is
# untouched, so the advanced view equals a cold ring build at the new
# window field for field.
# ---------------------------------------------------------------------------

def ring_positions(lo: int, capacity: int, device=None) -> torch.Tensor:
    """i64[C] time-first position resident in each ring slot: the unique p
    in [lo, lo + C) with p = slot (mod C).  ``torch.remainder`` floors as
    the reference's ``jnp.mod`` does (``s - lo`` is negative)."""
    s = torch.arange(capacity, dtype=torch.int64, device=device)
    return int(lo) + torch.remainder(s - int(lo), capacity)


def _gather_fields(g: TemporalGraph, eids: torch.Tensor):
    eids = eids.long()
    return (g.src[eids], g.dst[eids], g.t_start[eids], g.t_end[eids],
            g.weight[eids])


def _fields(g: TemporalGraph):
    return (g.src, g.dst, g.t_start, g.t_end, g.weight)


def index_ring_view(g: TemporalGraph, idx: TGERIndex, lo: int, hi: int, *,
                    capacity: int) -> EdgeView:
    """Cold build of the index-plan ring view: slot p % C holds time-first
    position p for p in [lo, lo + C), masked to the valid [lo, hi).  The
    same edge SET as ``index_view(g, idx, window, budget=C)``; only slot
    order differs, which no masked combine observes."""
    pos = ring_positions(lo, capacity, g.device)
    eids = idx.perm_by_start[pos.clamp(max=g.n_edges - 1)]
    return EdgeView(*_gather_fields(g, eids), pos < int(hi))


def _entering(lo_prev: int, lo_new: int, capacity: int, device):
    """The exact entering positions [lo_prev + C, lo_new + C) of one advance
    (host ints, so no padding slot is ever written)."""
    shift = int(lo_new) - int(lo_prev)
    if not 0 <= shift <= capacity:
        raise ValueError(
            f"a ring advance needs 0 <= lo_new - lo_prev ({shift}) <= "
            f"capacity ({capacity})")
    return torch.arange(int(lo_prev) + capacity, int(lo_new) + capacity,
                        dtype=torch.int64, device=device)


def _scatter_entering(fields, perm, prev: EdgeView, enter, slots) -> None:
    # end-of-stream positions clamp to the permutation's last entry, as in
    # the reference: those slots hold its payload bit for bit (masked dead)
    eids = perm[enter.clamp(max=perm.shape[0] - 1)].long()
    for p, f in zip(prev[:5], fields):
        p[slots] = f[eids]


def advance_index_ring_fields(fields, perm, prev: EdgeView, lo_prev: int,
                              lo_new: int, hi_new: int, *, capacity: int) -> EdgeView:
    """Raw-array form of :func:`advance_index_ring`: ``fields`` is the
    (src, dst, t_start, t_end, weight) tuple and ``perm`` the time-first
    permutation.  Writes ``prev``'s tensors IN PLACE and returns the view
    over them."""
    enter = _entering(lo_prev, lo_new, capacity, prev.src.device)
    _scatter_entering(fields, perm, prev, enter, torch.remainder(enter, capacity))
    prev.mask.copy_(ring_positions(lo_new, capacity, prev.src.device) < int(hi_new))
    return prev


def advance_index_ring(g: TemporalGraph, idx: TGERIndex, prev: EdgeView,
                       lo_prev: int, lo_new: int, hi_new: int, *, capacity: int) -> EdgeView:
    """Slide the index ring forward in place: write only the ENTERING
    positions [lo_prev + C, lo_new + C) into the slots they own (the ones
    being vacated), then recompute the mask.  Requires 0 <= lo_new - lo_prev
    <= C (the server checks and falls cold otherwise)."""
    return advance_index_ring_fields(
        _fields(g), idx.perm_by_start, prev, lo_prev, lo_new, hi_new,
        capacity=capacity)


def hybrid_ring_view(g: TemporalGraph, idx: TGERIndex, lo: int, hi: int, *,
                     capacity: int) -> EdgeView:
    """Cold build of the hybrid ring view: the light partition is a static
    prefix, the heavy partition a ring over the HEAVY time-first
    permutation ([lo, hi) are positions in that order).  The same edge SET
    as a completeness-budgeted ``hybrid_view``."""
    le = idx.light_eids
    l_mask = torch.arange(le.shape[0], device=g.device) < idx.n_light_edges
    pos = ring_positions(lo, capacity, g.device)
    heavy = idx.heavy_perm_by_start
    eids = heavy[pos.clamp(max=heavy.shape[0] - 1)]
    fields = [torch.cat([l, h]) for l, h in zip(_gather_fields(g, le),
                                                 _gather_fields(g, eids))]
    return EdgeView(*fields, torch.cat([l_mask, pos < int(hi)]))


def advance_hybrid_ring_fields(fields, heavy_perm, prev: EdgeView, lo_prev: int,
                               lo_new: int, hi_new: int, *, capacity: int) -> EdgeView:
    """Raw-array form of :func:`advance_hybrid_ring`, in place.  The light
    prefix length is ``len - C``."""
    L = prev.src.shape[0] - capacity
    enter = _entering(lo_prev, lo_new, capacity, prev.src.device)
    _scatter_entering(fields, heavy_perm, prev, enter,
                      L + torch.remainder(enter, capacity))
    prev.mask[L:] = ring_positions(lo_new, capacity, prev.src.device) < int(hi_new)
    return prev


def advance_hybrid_ring(g: TemporalGraph, idx: TGERIndex, prev: EdgeView,
                        lo_prev: int, lo_new: int, hi_new: int, *, capacity: int) -> EdgeView:
    """Slide the hybrid ring's heavy partition forward in place (positions
    over the heavy time-first permutation); the light prefix is untouched."""
    return advance_hybrid_ring_fields(
        _fields(g), idx.heavy_perm_by_start, prev, lo_prev, lo_new, hi_new,
        capacity=capacity)


def ring_companion_delta(src_field, perm, prev: EdgeView, lo_prev: int,
                         lo_new: int, *, capacity: int, light_prefix: int = 0):
    """Host ``(slots, old_from, new_from)`` of one ring advance: the slots
    it writes, their source vertex before (``prev`` is the view BEFORE the
    advance) and after.  ``light_prefix`` offsets hybrid slots past the
    light partition; end-of-stream positions clamp as the advance does."""
    lo_prev, lo_new = int(lo_prev), int(lo_new)
    enter = np.arange(lo_prev + capacity, lo_new + capacity, dtype=np.int64)
    slots = (light_prefix + (enter % capacity)).astype(np.int32)
    perm = to_numpy(perm)
    eids = perm[np.minimum(enter, perm.shape[0] - 1)]
    old_from = to_numpy(prev.src)[slots]
    new_from = to_numpy(src_field)[eids]
    return slots, old_from, new_from


def ring_view_for_plan(g: TemporalGraph, tger: Optional[TGERIndex], window,
                       plan: AccessPlan) -> Tuple[EdgeView, int, int, int]:
    """Cold ring build for the plan's method: ``(edges, lo, hi, capacity)``
    with (lo, hi) the host position range the server's advances slide
    (-1, -1, 0 for scan, whose 'ring' is the untouched graph view)."""
    if plan.method == "index":
        if tger is None or plan.budget <= 0:
            raise ValueError("index access requires a TGER and a positive budget")
        lo, hi = window_positions_host(tger, window)
        capacity = plan.ring_capacity or plan.budget
        if hi - lo > capacity:
            # a pinned plan whose rung predates this window: the ring holds
            # only [lo, lo + C), and the mask would validate slots the
            # gather never filled; refuse instead of serving a partial view
            raise ValueError(
                f"window {(int(window[0]), int(window[1]))} spans "
                f"{hi - lo} time-first positions but the pinned index "
                f"plan's ring capacity is {capacity}: under this plan the "
                f"serving horizon is the {capacity} most recent in-window "
                f"positions (>= position {hi - capacity}), and positions "
                f"[{lo}, {hi - capacity}) are below it.  Drop the pinned "
                f"plan so the planner re-rungs the capacity")
        return index_ring_view(g, tger, lo, hi, capacity=capacity), lo, hi, capacity
    if plan.method == "hybrid":
        if tger is None:
            raise ValueError("hybrid access requires a TGER")
        lo, hi = heavy_window_positions_host(tger, window)
        capacity = plan.ring_capacity or rung(max(hi - lo, 16))
        if hi - lo > capacity:  # the plan's rung predates this window: re-rung
            capacity = rung(hi - lo)
        return hybrid_ring_view(g, tger, lo, hi, capacity=capacity), lo, hi, capacity
    return scan_view(g), -1, -1, 0


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


RelaxFn = Callable[[EdgeView, torch.Tensor], Tuple[torch.Tensor, Optional[torch.Tensor]]]
# relax(edges, src_state_gathered) -> (candidate values [K, ...], extra valid
# [K] or None); batched, the gathered state and the outputs carry a leading
# window axis [W, K] and ``edges``' fields broadcast against it


def _gather_state(src_state, cols):
    """``src_state`` (a tensor or a tuple of tensors) at the edges' source
    columns ``cols`` (an index for [V] state, ``(slice, index)`` for [W, V])."""
    if isinstance(src_state, tuple):
        return tuple(a[cols] for a in src_state)
    return src_state[cols]


def edge_map_over_view(
    edges: EdgeView,
    window,                         # (ta, tb)
    frontier: torch.Tensor,         # bool[V]
    src_state,                      # [V, ...] tensor or tuple, gathered at the source side
    relax: RelaxFn,
    combine: str,
    *,
    plan: AccessPlan,
    n_vertices: int,
    direction: str = "out",
    check_window: bool = True,
    compute_touched: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One relaxation round over a PREBUILT edge view.  Returns
    ``(combined[V, ...], touched[V])``; ``touched`` marks the segments that
    received a valid contribution and costs an extra segment-sum, so
    ``compute_touched=False`` skips it and returns ``touched=None``."""
    from_v, to_v = _endpoints(edges, direction)
    from_v = from_v.long()
    valid = edges.mask & frontier[from_v]
    if check_window:
        valid = valid & in_window(edges.t_start, edges.t_end, window[0], window[1])
    cand, extra = relax(edges, _gather_state(src_state, from_v))
    if extra is not None:
        valid = valid & extra
    # the tile layout is the graph's native dst order: scan, out only
    out = combine_for_plan(plan, cand, to_v, n_vertices, combine, mask=valid,
                           use_layout=plan.method == "scan" and direction == "out")
    if not compute_touched:
        return out, None
    touched = segment_combine(valid.to(torch.int32), to_v, n_vertices, "sum",
                              axis=plan.edge_axis) > 0
    return out, touched


def temporal_edge_map(
    g: TemporalGraph,
    window,                         # (ta, tb)
    frontier: torch.Tensor,         # bool[V]
    src_state,                      # [V, ...] tensor or tuple, gathered at the source side
    relax: RelaxFn,
    combine: str,
    *,
    pred: Optional[OrderingPredicateType] = None,
    direction: str = "out",         # 'out': reduce into dst; 'in': reduce into src
    tger: Optional[TGERIndex] = None,
    plan: Optional[AccessPlan] = None,
    check_window: bool = True,
    compute_touched: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One round of temporal edge relaxation under an AccessPlan (Table 2's
    TemporalEdgeMap): build the plan's view, relax the frontier's valid
    edges and combine into ``to`` vertices.  Returns ``(combined[V, ...],
    touched[V] or None)``.  The ordering predicate is evaluated inside
    ``relax`` (it needs algorithm state); ``pred`` is accepted for symmetry
    with Table 2.  A min-combine into destinations over a scan view on
    ``pallas_tiled`` runs K1; every other combine takes the segment path."""
    plan = ensure_plan(plan)
    edges = view_for_plan(g, tger, window, plan)
    return edge_map_over_view(
        edges, window, frontier, src_state, relax, combine, plan=plan,
        n_vertices=g.n_vertices, direction=direction, check_window=check_window,
        compute_touched=compute_touched)


def edge_map_over_view_batched(
    edges: EdgeView,
    windows,                        # [W, 2]
    frontiers: torch.Tensor,        # bool[W, V]
    src_state,                      # [W, V, ...] tensor or tuple: per-window state
    relax: RelaxFn,
    combine: str,
    *,
    plan: AccessPlan,
    n_vertices: int,
    direction: str = "out",
    check_window: bool = True,
    compute_touched: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One batched round over a PREBUILT (union-window) view: every window
    masks the shared candidate edges and the combine runs once as a [W, ·]
    reduction (one K1 launch for all W on a tiled scan plan).  Returns
    ``(combined[W, V, ...], touched[W, V] or None)``."""
    from_v, to_v = _endpoints(edges, direction)
    from_v = from_v.long()
    windows = torch.as_tensor(windows, dtype=torch.int32,
                              device=edges.src.device).reshape(-1, 2)
    valid = edges.mask[None, :] & frontiers[:, from_v]
    if check_window:
        valid = valid & in_window(edges.t_start[None, :], edges.t_end[None, :],
                                  windows[:, 0:1], windows[:, 1:2])
    cand, extra = relax(edges, _gather_state(src_state, (slice(None), from_v)))
    if extra is not None:
        valid = valid & extra
    cand = torch.broadcast_to(cand, valid.shape + cand.shape[valid.dim():])
    out = combine_windows_for_plan(plan, cand, to_v, n_vertices, combine, masks=valid,
                                   use_layout=plan.method == "scan" and direction == "out")
    if not compute_touched:
        return out, None
    touched = segment_combine_windows(valid.to(torch.int32), to_v, n_vertices,
                                      "sum", axis=plan.edge_axis) > 0
    return out, touched


def temporal_edge_map_batched(
    g: TemporalGraph,
    windows,                        # [W, 2] query windows
    frontiers: torch.Tensor,        # bool[W, V]
    src_state,                      # [W, V, ...] tensor or tuple
    relax: RelaxFn,
    combine: str,
    *,
    pred: Optional[OrderingPredicateType] = None,
    direction: str = "out",
    tger: Optional[TGERIndex] = None,
    plan: Optional[AccessPlan] = None,
    check_window: bool = True,
    compute_touched: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Batched multi-window TemporalEdgeMap: ONE view over the union window
    serves all W windows.  Plans from ``plan_query(..., windows=[...])``
    budget for the union, so each window's valid edges are a masked subset
    of the one gathered candidate set."""
    plan = ensure_plan(plan)
    windows = to_numpy(windows).astype(np.int32).reshape(-1, 2)
    edges = view_for_plan(g, tger, union_window(windows), plan)
    return edge_map_over_view_batched(
        edges, windows, frontiers, src_state, relax, combine, plan=plan,
        n_vertices=g.n_vertices, direction=direction, check_window=check_window,
        compute_touched=compute_touched)


def vertex_map(frontier: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """VertexMap (Table 2): the new frontier {u in U | F(u)}, F vectorized
    over vertex ids."""
    return frontier & fn(torch.arange(frontier.shape[-1], device=frontier.device))


def frontier_nonempty(frontier: torch.Tensor) -> torch.Tensor:
    return frontier.any()


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
    "hybrid_budget",
    "ensure_plan",
    "view_for_plan",
    "union_window",
    "frontier_from_sources",
    "frontier_nonempty",
    "temporal_edge_map",
    "temporal_edge_map_batched",
    "edge_map_over_view",
    "edge_map_over_view_batched",
    "vertex_map",
    "segment_combine",
    "segment_combine_windows",
    "FrontierView",
    "build_frontier_view",
    "advance_frontier_view",
    "companion_for_view",
    "ring_positions",
    "index_ring_view",
    "advance_index_ring",
    "advance_index_ring_fields",
    "hybrid_ring_view",
    "advance_hybrid_ring",
    "advance_hybrid_ring_fields",
    "ring_companion_delta",
    "ring_view_for_plan",
    "INT_INF",
    "FLOAT_INF",
]
