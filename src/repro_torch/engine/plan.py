"""AccessPlan: the one planning surface for every access path.

``plan_query`` turns (graph, TGER, window — or a batch of windows) into an
:class:`AccessPlan`: method (scan | index | hybrid), budgets and execution
backend, decided once on the host.  The plan carries the tile layout as
tensors on the graph's device when the tiled backend runs it.

Backend names and cache-key strings are those of the JAX package
(``"xla_segment"``, ``"pallas_tiled"``), so the two packages' plans compare
equal: ``xla_segment`` is the masked ``scatter_reduce_`` path here and
``pallas_tiled`` the hand-written tile-min kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hostcache import identity_cache
from repro_torch.core.selective import AccessDecision, CostModel, decide_access
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import (
    TGERIndex,
    heavy_window_positions_host,
    window_positions_host,
)
from repro_torch.device import to_numpy
from repro_torch.kernels.ops import prepare_layout

METHODS = ("scan", "index", "hybrid")
BACKENDS = ("xla_segment", "pallas_tiled")
TIERS = ("hot", "cold", "split")

DEFAULT_TILE_V = 512
DEFAULT_BLOCK_E = 1024


@dataclasses.dataclass(frozen=True)
class AccessPlan:
    """One algorithm run's access decision, produced on the host.

    ``layout_perm`` / ``layout_block_tile`` hold the destination-tile
    layout for the ``pallas_tiled`` backend, zero-length otherwise."""

    layout_perm: torch.Tensor        # i32[Ep] dst-tile-grouped edge ids (-1 pad)
    layout_block_tile: torch.Tensor  # i32[NB] output tile owned by each block
    method: str                      # scan | index | hybrid
    backend: str                     # xla_segment | pallas_tiled
    budget: int                      # global gather budget (index)
    per_vertex_budget: int           # hybrid heavy-vertex budget
    # Distributed engine: the top-K wire budget of the frontier-sparse
    # exchange (0 = one dense min-reduce of the state per round).
    exchange_budget: int
    tile_v: int
    block_e: int
    n_tiles: int
    n_edges: int                     # layout domain (0 = no layout)
    cache_key: str
    n_windows: int = 0               # batched sweep width (0 = single window)
    ring_capacity: int = 0           # ring-view slot count (0 = derive)
    batch_sig: str = ""              # QueryBatch shape signature ("" = not a batch plan)
    # The mesh dimension the edge axis of every view under this plan is
    # sharded over (a ``repro_torch.distributed.MeshAxis``: its name and
    # process group), or None.  Set only inside an edge-sharded solve
    # (``dataclasses.replace``): every combine then takes the segment path
    # and ends with one collective over this dimension.
    edge_axis: Any = None
    # History tier of the planned window against a ColdStore's hot horizon:
    # "hot" (the ring serves it), "cold" (entirely below the horizon,
    # stitched from compacted chunks) or "split" (cold prefix + hot suffix
    # in one stitched view).  On the cache key, so a tier switch falls cold
    # without consuming the carried hot state.
    tier: str = "hot"
    # Frontier-rung ladder cap (engine/frontier.py): 0 disables; a positive
    # value is the largest frontier occupancy (vertex rung) the sparse
    # segments of a laddered fixpoint serve.  Host-level ``*_over_view``
    # solves under such a plan descend to frontier-proportional rounds; the
    # batched entry points, ``sweep`` and a serving advance stay dense.
    ladder: int = 0

    @property
    def view_budget(self) -> int:
        """The budget the edge-view builder needs for this method."""
        return self.per_vertex_budget if self.method == "hybrid" else self.budget


def _cache_key(method: str, backend: str, budget: int, pvb: int, exchange: int,
               tile_v: int, block_e: int, n_windows: int, ring_capacity: int,
               batch_sig: str = "", tier: str = "hot", ladder: int = 0) -> str:
    """The JAX package's key format."""
    key = f"{method}/{backend}/b{budget}/pv{pvb}/x{exchange}/t{tile_v}x{block_e}"
    if ring_capacity:
        key += f"/r{ring_capacity}"
    if n_windows:
        key += f"/w{n_windows}"
    if batch_sig:
        key += f"/q{batch_sig}"
    if tier != "hot":
        key += f"/T{tier}"
    if ladder:
        key += f"/L{ladder}"
    return key


def rung(n: int) -> int:
    """The budget ladder: round up to a power of two."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def make_plan(
    method: str = "scan",
    backend: str = "xla_segment",
    *,
    budget: int = 0,
    per_vertex_budget: int = 0,
    exchange_budget: int = 0,
    layout=None,
    n_edges: int = 0,
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
    n_windows: int = 0,
    ring_capacity: int = 0,
    batch_sig: str = "",
    tier: str = "hot",
    ladder: int = 0,
) -> AccessPlan:
    """Direct plan constructor (the planner-free path: tests, defaults).
    ``layout``'s arrays become tensors on the device they already have
    (host arrays go to the CPU)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if ladder < 0:
        raise ValueError(f"ladder must be >= 0, got {ladder}")
    if layout is not None:
        perm = torch.as_tensor(layout.perm, dtype=torch.int32)
        block_tile = torch.as_tensor(layout.block_tile, dtype=torch.int32,
                                     device=perm.device)
        tile_v, block_e, n_tiles = layout.tile_v, layout.block_e, layout.n_tiles
    else:
        perm = torch.zeros(0, dtype=torch.int32)
        block_tile = torch.zeros(0, dtype=torch.int32)
        n_tiles = 0
        if backend == "pallas_tiled":
            raise ValueError("pallas_tiled backend requires a TileLayout")
    return AccessPlan(
        layout_perm=perm,
        layout_block_tile=block_tile,
        method=method,
        backend=backend,
        budget=int(budget),
        per_vertex_budget=int(per_vertex_budget),
        exchange_budget=int(exchange_budget),
        tile_v=int(tile_v),
        block_e=int(block_e),
        n_tiles=int(n_tiles),
        n_edges=int(n_edges),
        cache_key=_cache_key(method, backend, int(budget), int(per_vertex_budget),
                             int(exchange_budget), int(tile_v), int(block_e),
                             int(n_windows), int(ring_capacity), str(batch_sig),
                             tier=str(tier), ladder=int(ladder)),
        n_windows=int(n_windows),
        ring_capacity=int(ring_capacity),
        batch_sig=str(batch_sig),
        tier=str(tier),
        ladder=int(ladder),
    )


# composite-key array per_vertex_window_budget bisects, built once per
# (graph, TGER): each query is then one 2H searchsorted.
@identity_cache(8)
def _pvb_keys(t_start, out_offsets, indexed_ids):
    ts = to_numpy(t_start).astype(np.int64)
    off = to_numpy(out_offsets).astype(np.int64)
    hv = to_numpy(indexed_ids)
    hv = hv[hv >= 0].astype(np.int64)
    if hv.size == 0:
        return None
    lo, hi = off[hv], off[hv + 1]
    lens = hi - lo
    total = int(lens.sum())
    if total == 0:
        return None
    starts = np.cumsum(lens) - lens
    flat = np.repeat(lo - starts, lens) + np.arange(total)
    rank = np.repeat(np.arange(hv.size, dtype=np.int64), lens)
    base = np.int64(np.iinfo(np.int32).min)
    keys = (rank << 33) + (ts[flat] - base)
    slots = np.arange(hv.size, dtype=np.int64) << 33
    return (keys, slots, base, hv.size)


def per_vertex_window_budget(
    g: TemporalGraph,
    idx: TGERIndex,
    window: Tuple[int, int],
    floor: int = 16,
) -> int:
    """Per-vertex budget for the hybrid view: the max in-window start-count
    over indexed vertices, rounded to a power of two (exact)."""
    if idx.n_indexed == 0:
        return floor
    entry = _pvb_keys(g.t_start, g.out_offsets, idx.indexed_ids)
    if entry is None:
        worst = floor
    else:
        keys, slots, base, n_hv = entry
        ws, we = int(window[0]), int(window[1])
        queries = np.concatenate([slots + (ws - base), slots + (we + 1 - base)])
        bounds = np.searchsorted(keys, queries, side="left")
        counts = bounds[n_hv:] - bounds[:n_hv]
        worst = max(floor, int(counts.max()))
    return 1 << (worst - 1).bit_length() if worst > 1 else 1


def heavy_window_budget(
    g: TemporalGraph,
    idx: TGERIndex,
    window: Tuple[int, int],
    floor: int = 16,
) -> int:
    """Ring-capacity rung for the hybrid ring view: the count of heavy edges
    whose start lies in the window, rounded to a power of two."""
    lo, hi = heavy_window_positions_host(idx, (int(window[0]), int(window[1])))
    return rung(max(hi - lo, floor))


def plan_query(
    g: TemporalGraph,
    tger: Optional[TGERIndex],
    window=None,
    *,
    windows=None,
    model: CostModel = CostModel(),
    access: str = "auto",
    backend: str = "xla_segment",
    exchange_budget: int = 0,
    hybrid_floor: int = 16,
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
    coldstore=None,
    tier: Optional[str] = None,
    ladder: int = 0,
) -> AccessPlan:
    """THE planner: one host-side decision per algorithm run.

    ``access`` is ``"auto"`` (paper Eq. 3 via the SAT estimate, scan vs
    index) or a forced ``"scan"`` / ``"index"`` / ``"hybrid"``.  ``backend``
    is ``"xla_segment"`` or ``"pallas_tiled"``; the tiled backend needs the
    scan method (the layout is a per-graph static grouping), so any other
    method falls back to ``xla_segment``, recorded in the plan.

    ``windows=[(t0, t1), ...]`` plans a batched sweep over the union window
    whose budgets cover every member window.

    ``coldstore`` (a :class:`~repro_torch.core.coldstore.ColdStore`)
    classifies the union window against the compacted-history horizon: at
    or above the store's watermark it plans ``tier="hot"`` as before;
    entirely below, ``tier="cold"``; straddling, ``tier="split"``.  Both
    of the latter force the index method with the capacity rung taken
    from the exact position span, so the stitched view always covers.
    ``tier=`` overrides the classification (the server passes the tier it
    computed against its own carried ring's horizon).

    ``ladder`` (>= 0) is the frontier-rung cap the plan carries
    (:attr:`AccessPlan.ladder`, ``/L{N}`` on the cache key).
    ``exchange_budget`` is the distributed engine's top-K wire budget
    (``x{K}`` on the cache key; 0 is the dense exchange).
    """
    if ladder < 0:
        raise ValueError(f"ladder must be >= 0, got {ladder}")
    if access not in ("auto",) + METHODS:
        raise ValueError(f"access must be auto|{'|'.join(METHODS)}, got {access!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")

    n_windows = 0
    if windows is not None:
        if window is not None:
            raise ValueError(
                "pass either window=... or windows=[...], not both "
                "(a single window is not implicitly added to the batch)")
        wins = [(int(w[0]), int(w[1])) for w in to_numpy(windows).reshape(-1, 2)]
        if not wins:
            raise ValueError("windows must be a non-empty sequence of (t0, t1)")
        n_windows = len(wins)
        win = (min(w[0] for w in wins), max(w[1] for w in wins))  # union
        member_wins = wins
    else:
        if window is None:
            raise ValueError("plan_query needs window=... or windows=[...]")
        win = (int(window[0]), int(window[1]))
        member_wins = []
    n_edges = g.n_edges

    budget = 0
    per_vertex = 0
    ring_capacity = 0
    if tger is None:
        method = "scan"
        if access in ("index", "hybrid"):
            raise ValueError(f"access={access!r} requires a TGER index")
    elif access == "hybrid":
        method = "hybrid"
        per_vertex = per_vertex_window_budget(g, tger, win, floor=hybrid_floor)
        for w in member_wins:
            per_vertex = max(
                per_vertex, per_vertex_window_budget(g, tger, w, floor=hybrid_floor))
        ring_capacity = heavy_window_budget(g, tger, win, floor=hybrid_floor)
    else:
        dec = decide_access(tger, n_edges, win, model,
                            force=None if access == "auto" else access)
        method = dec.method
        if method == "index":
            budget = dec.budget
            for w in member_wins:
                wdec = decide_access(tger, n_edges, w, model, force="index")
                budget = max(budget, wdec.budget)
            # coverage floor: the exact union position span
            p_lo, p_hi = window_positions_host(tger, win)
            budget = max(budget, rung(max(p_hi - p_lo, 1)))
            ring_capacity = budget

    # ---- history-tier classification ----------------------------------------
    if tier is None:
        tier = "hot"
        if (coldstore is not None and tger is not None
                and access in ("auto", "index")):
            tier = coldstore.classify(win)
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if tier != "hot":
        if tger is None:
            raise ValueError("tier planning requires a TGER index")
        if access not in ("auto", "index"):
            raise ValueError(
                f"tier={tier!r} (below-horizon) windows require the index "
                f"method: the cold store stitches a classic index ring "
                f"view; got access={access!r}")
        p_lo, p_hi = window_positions_host(tger, win)
        method = "index"
        budget = max(budget, rung(max(p_hi - p_lo, 16)))
        ring_capacity = budget

    if backend == "pallas_tiled" and method != "scan":
        backend = "xla_segment"  # tile layout is per-graph static: scan only

    layout = (prepare_layout(g.dst, g.n_vertices, tile_v, block_e)
              if backend == "pallas_tiled" else None)
    return make_plan(
        method, backend,
        budget=budget, per_vertex_budget=per_vertex,
        exchange_budget=int(exchange_budget),
        layout=layout, n_edges=n_edges if layout is not None else 0,
        tile_v=tile_v, block_e=block_e,
        n_windows=n_windows, ring_capacity=ring_capacity, tier=tier,
        ladder=int(ladder),
    )


def plan_batch(
    g: TemporalGraph,
    tger: Optional[TGERIndex],
    batch,
    *,
    model: CostModel = CostModel(),
    access: str = "auto",
    backend: str = "xla_segment",
    shards=None,
    bucketed: bool = False,
    **kw,
) -> AccessPlan:
    """ONE union AccessPlan for a whole :class:`~repro_torch.engine.queries.
    QueryBatch`: ``plan_query`` over the batch's distinct windows (budgets
    cover the union and every member window), with the batch's shape
    signature on the cache key (``batch_sig``).  The signature keys group
    structure and row counts, never sources or window bounds, so a
    shape-stable tenant stream keeps one plan.

    ``bucketed`` keys the signature on the BUCKETED per-group row
    capacities (the admission ladder) instead of exact counts, so tenant
    churn inside a bucket replans to the same cache key.

    ``shards`` (the serving mesh's shape) rides the signature too, since a
    sharded advance pads each group's rows to a per-rank capacity: an int
    is a 1-D query mesh (``@qD``), an ``(E, D)`` tuple the 2-D edge x query
    mesh (``@eEqD``); ``(1, D)`` is the 1-D form, whose program it runs.
    A state carried under one mesh shape therefore never matches a plan
    made for another."""
    plan = plan_query(g, tger, windows=batch.windows(), model=model,
                      access=access, backend=backend, **kw)
    sig = batch.signature(bucketed=bucketed)
    if shards is not None:
        if isinstance(shards, (tuple, list)):
            e, d = int(shards[0]), int(shards[1])
            sig += f"@q{d}" if e <= 1 else f"@e{e}q{d}"
        else:
            sig += f"@q{int(shards)}"
    return dataclasses.replace(
        plan, batch_sig=sig,
        cache_key=_cache_key(plan.method, plan.backend, plan.budget,
                             plan.per_vertex_budget, plan.exchange_budget,
                             plan.tile_v, plan.block_e, plan.n_windows,
                             plan.ring_capacity, sig, tier=plan.tier,
                             ladder=plan.ladder))


def decision_for(
    g: TemporalGraph,
    tger: Optional[TGERIndex],
    window,
    model: CostModel = CostModel(),
    force: Optional[str] = None,
) -> AccessDecision:
    """The planner's scan-vs-index decision for one window (diagnostics)."""
    if tger is None:
        return AccessDecision("scan", 0, float(g.n_edges), 1.0, 0.0, 0.0)
    return decide_access(
        tger, g.n_edges, (int(window[0]), int(window[1])), model, force=force)


__all__ = [
    "AccessPlan",
    "make_plan",
    "plan_query",
    "plan_batch",
    "decision_for",
    "per_vertex_window_budget",
    "heavy_window_budget",
    "rung",
    "METHODS",
    "BACKENDS",
    "TIERS",
]
