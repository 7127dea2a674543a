"""TGER — Temporal Graph Edge Registry (paper §3.1, §4.3).

The paper's per-vertex priority-search tree becomes a time-first layout:

  1. a global permutation of edge ids sorted by t_start — a window query
     [ta, tb] is two ``searchsorted`` calls giving a contiguous position
     range, from which the index path gathers a power-of-two budget;
  2. equi-depth time buckets over that order;
  3. per-vertex 3-sided queries by bisection inside each start-sorted
     T-CSR slice (``bounded_searchsorted``);
  4. SAT histograms of the indexed vertices only (degree >= cutoff);
  5. a heavy time-first permutation (edges whose source is indexed).

The build is host numpy; its tensors go to the graph's device.  The
histograms stay on the host, where the planner reads them.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from repro_torch.core.histogram import (
    DEFAULT_BUCKETS,
    Histogram2D,
    build_histogram,
    stack_histograms,
)
from repro_torch.core.hostcache import identity_cache
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.device import to_numpy

DEFAULT_DEGREE_CUTOFF = 2048  # paper §5: "currently set to 2k edges"


@dataclasses.dataclass(frozen=True)
class TGERIndex:
    # -- global time-first layout -------------------------------------------
    perm_by_start: torch.Tensor    # i32[E] edge ids sorted by t_start
    start_sorted: torch.Tensor     # i32[E] t_start in ascending order
    bucket_bounds: torch.Tensor    # i32[B+1] equi-depth start-time boundaries
    # -- host histograms (planner input) -------------------------------------
    global_hist: Histogram2D
    # -- per-vertex selective index ------------------------------------------
    indexed_ids: torch.Tensor      # i32[H] vertex ids with a TGER slot (-1 placeholder)
    vertex_hist: Histogram2D       # batched [H, nb+1, nb+1]
    vertex_to_slot: torch.Tensor   # i32[V]; -1 when the vertex is not indexed
    # -- heavy/light edge partition (hybrid edgemap) --------------------------
    light_eids: torch.Tensor       # i32[E_light] edges whose src is NOT indexed
    heavy_perm_by_start: torch.Tensor  # i32[max(E_heavy, 1)] heavy edge ids by t_start
    heavy_start_sorted: torch.Tensor   # i32[max(E_heavy, 1)] their t_start, ascending
    # -- static ---------------------------------------------------------------
    degree_cutoff: int
    n_indexed: int
    n_buckets_time: int
    n_light_edges: int
    n_heavy_edges: int


def build_tger(
    g: TemporalGraph,
    degree_cutoff: int = DEFAULT_DEGREE_CUTOFF,
    n_time_buckets: int = 64,
    n_hist_buckets: int = DEFAULT_BUCKETS,
    index_in_edges: bool = False,
) -> TGERIndex:
    """IndexVertices (paper Alg. 1) on the host; tensors follow ``g``."""
    t_start = to_numpy(g.t_start)
    t_end = to_numpy(g.t_end)
    E = g.n_edges

    perm = np.argsort(t_start, kind="stable").astype(np.int32)
    start_sorted = t_start[perm]

    B = min(n_time_buckets, max(E, 1))
    idx = np.linspace(0, max(E - 1, 0), B + 1).astype(np.int64)
    bucket_bounds = start_sorted[idx] if E else np.zeros(B + 1, np.int64)

    global_hist = build_histogram(t_start, t_end, n_hist_buckets)

    offsets = to_numpy(g.out_offsets)
    deg = offsets[1:] - offsets[:-1]
    if index_in_edges:
        in_off = to_numpy(g.in_offsets)
        deg = np.maximum(deg, in_off[1:] - in_off[:-1])
    indexed = np.nonzero(deg >= degree_cutoff)[0].astype(np.int32)
    hists = [
        build_histogram(t_start[offsets[v]:offsets[v + 1]],
                        t_end[offsets[v]:offsets[v + 1]], n_hist_buckets)
        for v in indexed
    ]
    if not hists:  # keep a 1-slot placeholder so shapes stay non-empty
        hists = [build_histogram(np.zeros(0), np.zeros(0), n_hist_buckets)]
        indexed_arr = np.full(1, -1, np.int32)
    else:
        indexed_arr = indexed
    vertex_hist = stack_histograms(hists)

    vertex_to_slot = np.full(g.n_vertices, -1, np.int32)
    vertex_to_slot[indexed] = np.arange(indexed.size, dtype=np.int32)

    src_np = to_numpy(g.src)
    is_heavy_src = vertex_to_slot[src_np] >= 0
    light_eids = np.nonzero(~is_heavy_src)[0].astype(np.int32)
    if light_eids.size == 0:
        light_eids = np.zeros(1, np.int32)
        n_light = 0
    else:
        n_light = int(light_eids.size)

    heavy_eids = np.nonzero(is_heavy_src)[0].astype(np.int32)
    n_heavy = int(heavy_eids.size)
    if n_heavy:
        heavy_perm = heavy_eids[np.argsort(t_start[heavy_eids], kind="stable")]
    else:
        heavy_perm = np.zeros(1, np.int32)
    heavy_start_sorted = t_start[heavy_perm].astype(np.int32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=g.device)

    return TGERIndex(
        perm_by_start=dev(perm),
        start_sorted=dev(start_sorted),
        bucket_bounds=dev(bucket_bounds),
        global_hist=global_hist,
        indexed_ids=dev(indexed_arr),
        vertex_hist=vertex_hist,
        vertex_to_slot=dev(vertex_to_slot),
        light_eids=dev(light_eids),
        heavy_perm_by_start=dev(heavy_perm),
        heavy_start_sorted=dev(heavy_start_sorted),
        degree_cutoff=int(degree_cutoff),
        n_indexed=int(len(indexed)),
        n_buckets_time=int(B),
        n_light_edges=n_light,
        n_heavy_edges=n_heavy,
    )


# --------------------------------------------------------------------------
# query primitives (device)
# --------------------------------------------------------------------------

def window_range(idx: TGERIndex, window_start, window_end):
    """Positions [lo, hi) in the time-first order whose start lies in
    [window_start, window_end], as 0-d int64 tensors on the index's device."""
    lo = torch.searchsorted(idx.start_sorted, int(window_start), side="left")
    hi = torch.searchsorted(idx.start_sorted, int(window_end), side="right")
    return lo, hi


def gather_window_edges(idx: TGERIndex, lo, budget: int):
    """``budget`` edge ids of the time-first order from ``lo`` on; callers
    mask positions >= hi.  Returns (edge_ids, positions), with out-of-range
    positions clamped for the gather."""
    pos = lo + torch.arange(budget, dtype=torch.int64, device=idx.perm_by_start.device)
    pos_c = pos.clamp(max=idx.start_sorted.shape[0] - 1)
    return idx.perm_by_start[pos_c], pos


def bounded_searchsorted(arr: torch.Tensor, lo, hi, value, side: str = "left",
                         iters: int = 32) -> torch.Tensor:
    """Binary search for ``value`` inside the sorted slice arr[lo:hi] with a
    fixed ``iters``-step bisection (any slice shorter than 2**iters).
    Vectorized over lo/hi/value; returns int64 positions."""
    dev = arr.device
    lo = torch.as_tensor(lo, device=dev).long()
    hi = torch.as_tensor(hi, device=dev).long()
    value = torch.as_tensor(value, device=dev)
    last = max(arr.shape[0] - 1, 0)
    for _ in range(iters):
        mid = (lo + hi) // 2
        mv = arr[mid.clamp(0, last)]
        go_right = (mv < value) if side == "left" else (mv <= value)
        active = lo < hi
        lo, hi = (torch.where(active & go_right, mid + 1, lo),
                  torch.where(active & ~go_right, mid, hi))
    return lo


def vertex_range(g: TemporalGraph, v, start_lo, start_hi):
    """Edge-id range of v's out-edges with t_start in [start_lo, start_hi].
    Vectorized over ``v``/bounds."""
    v = torch.as_tensor(v, device=g.device).long()
    lo0 = g.out_offsets[v]
    hi0 = g.out_offsets[v + 1]
    lo = bounded_searchsorted(g.t_start, lo0, hi0, start_lo, side="left")
    hi = bounded_searchsorted(g.t_start, lo0, hi0, start_hi, side="right")
    return lo, hi


def vertex_prefix(g: TemporalGraph, v, start_bound, strict: bool = False):
    """Per-vertex 3-sided query, heap axis: the edge-id range [lo, hi) of
    ``v``'s out-edges with t_start <= start_bound (< when ``strict``), by
    bisection inside its start-sorted T-CSR slice.  Vectorized over
    ``v``/``start_bound``."""
    v = torch.as_tensor(v, device=g.device).long()
    lo = g.out_offsets[v]
    pos = bounded_searchsorted(g.t_start, lo, g.out_offsets[v + 1], start_bound,
                               side="left" if strict else "right")
    return lo, pos


# --------------------------------------------------------------------------
# host-side window positions (one device->host copy per TGER)
# --------------------------------------------------------------------------

@identity_cache(16)
def _host_sorted(arr: torch.Tensor) -> np.ndarray:
    return to_numpy(arr)


def window_positions_host(idx: TGERIndex, window) -> tuple:
    """Host-side [lo, hi) of ``window`` in the global time-first order."""
    ss = _host_sorted(idx.start_sorted)
    return (bisect.bisect_left(ss, int(window[0])),
            bisect.bisect_right(ss, int(window[1])))


def heavy_window_positions_host(idx: TGERIndex, window) -> tuple:
    """Host-side [lo, hi) of ``window`` in the heavy time-first order."""
    hs = _host_sorted(idx.heavy_start_sorted)
    n = idx.n_heavy_edges
    return (min(bisect.bisect_left(hs, int(window[0])), n),
            min(bisect.bisect_right(hs, int(window[1])), n))


__all__ = [
    "TGERIndex",
    "build_tger",
    "window_range",
    "gather_window_edges",
    "bounded_searchsorted",
    "vertex_range",
    "vertex_prefix",
    "window_positions_host",
    "heavy_window_positions_host",
    "DEFAULT_DEGREE_CUTOFF",
]
