"""Window-query serving: cold sweeps and the multi-tenant incremental server.

  * ``sweep`` / ``sweep_looped`` — one query over W windows in one batched
    execution over the union window's view, and its reference of W
    independent single-window runs under the same plan; seven algorithms.
  * ``serve_batch`` — the multi-tenant entry point: a whole
    :class:`~repro_torch.engine.queries.QueryBatch` of (algorithm x source
    x window) rows, bucketed into (algorithm, params) groups, answered over
    ONE union plan (``plan_batch``) and ONE ring view, carrying a
    :class:`SweepState` so the next batch advances incrementally.
  * ``sweep_incremental`` — the single-tenant wrapper (one algorithm, one
    source, W sliding windows) over the same engine.

A steady-state advance writes only the entering time-first range into the
carried ring view (in place), solves only the genuinely new rows of every
group (identical (source, window) rows across tenants dedup to one solved
row and fan out at assembly) and assembles every group's [Q, V] result.
The JAX package traces that advance into one jitted program with the ring
and result buffers donated; here it runs eagerly, and the in-place ring
write is the donation: a state passed to an advance is consumed
(moved-from) and raises if passed again.  Warm starts sit behind
``warm_start=`` (EA and cc exact, reachability sound, the rest refused).

Integer-label rows are bit-identical to the cold ``sweep`` under the same
plan; float rows (pagerank, betweenness) match up to summation order.

``admission="bucketed"`` pads every group's rows to a power-of-two bucket
and carries row assignment as int32 gather maps, so tenant churn inside a
bucket keeps every shape (the serving daemon's mode).

``mesh=D`` (a 1-D query mesh) or ``mesh=(E, D)`` (the 2-D edge x query
mesh) shards the serving: every rank of the process group calls
``serve_batch`` with the same batch, each solves its contiguous chunk of
every group's padded new rows under its own convergence loop, and the
chunks are all-gathered along the query dimension, so every rank ends the
advance with every row.  At E > 1 the index ring itself is split into E
contiguous slot chunks (a delta lands only on its owning rank) and every
combine of a solve ends with one collective across the edge dimension.  ``coldstore=`` seals
the positions an index ring evicts into a :class:`~repro_torch.core.
coldstore.ColdStore` and serves windows below the hot horizon from it (the
cold tier), bit-identical to a full-history index solve.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.algorithms import (
    earliest_arrival,
    earliest_arrival_batched,
    overlaps_reachability,
    overlaps_reachability_batched,
    temporal_betweenness,
    temporal_betweenness_batched,
    temporal_bfs,
    temporal_bfs_batched,
    temporal_cc,
    temporal_cc_batched,
    temporal_kcore,
    temporal_kcore_batched,
    temporal_pagerank,
    temporal_pagerank_batched,
    temporal_pagerank_over_view,
)
from repro_torch.core.algorithms.bfs import _temporal_bfs_over_view
from repro_torch.core.algorithms.centrality import _temporal_betweenness_over_view
from repro_torch.core.algorithms.connectivity import _temporal_cc_over_view
from repro_torch.core.algorithms.kcore import _temporal_kcore_over_view
from repro_torch.core.algorithms.paths import _earliest_arrival_over_view
from repro_torch.core.algorithms.reachability import _overlaps_reachability_over_view
from repro_torch.core.edgemap import (
    INT_INF,
    EdgeView,
    _entering,
    _scatter_entering,
    advance_hybrid_ring_fields,
    advance_index_ring_fields,
    ring_positions,
    ring_view_for_plan,
)
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import (
    TGERIndex,
    heavy_window_positions_host,
    window_positions_host,
)
from repro_torch.device import to_numpy
from repro_torch.distributed.collectives import all_gather, all_reduce, mesh_axis
from repro_torch.distributed.query_shard import (
    mesh_shape,
    query_mesh,
    replicate,
    replicated_arrays,
    row_partition,
    serve_mesh,
)
from repro_torch.engine.frontier import ladder_eligible
from repro_torch.engine.plan import (
    AccessPlan,
    per_vertex_window_budget,
    plan_batch,
    plan_query,
)
from repro_torch.engine.queries import (
    QueryBatch,
    QuerySpec,
    bucket_capacity,
    dedup_rows,
)
from repro_torch.obs import dispatch_log

# the ring capacity at or below which ``sweep_incremental(tiny_budget_gate=
# True)`` serves a chain cold: the reference's threshold, kept for parity
# with it.  On the H100 the gate loses at it (6 advances of a 64-slot index
# chain: 2.301 ms gated against 1.915 ungated, and 1.837 against 1.539 in a
# second run, from chip_smoke.py's ``tiny_gate_stream``), so the option
# stays off by default.
TINY_BUDGET_RING = 64

# ---------------------------------------------------------------------------
# the algorithm dispatch table
# ---------------------------------------------------------------------------

class _Algo(NamedTuple):
    """One algorithm's serving contract.

    ``solve(edges, windows, sources, plan, n_vertices, init, kwargs,
    ladder)`` runs a group's rows over a prebuilt (ring) view and returns
    ``(result, rounds)``: the round count for EA, -1 otherwise; ``ladder``
    says whether the frontier-rung ladder may run (cold solves, as in the
    JAX package, where only the fused advance is traced).  ``warm`` builds
    a containment warm init for new rows (None: warm starts refused).
    ``n_outputs`` is the result-tuple arity (1 = one [Q, V])."""

    solve: Callable
    batched: Callable               # cold batched entry (sweep)
    single: Callable                # cold single-window entry (sweep_looped)
    n_outputs: int
    source_free: bool
    warm: Optional[Callable]


def _require_k(kw):
    if "k" not in kw:
        raise ValueError("algorithm='kcore' requires the k= parameter")
    kw = dict(kw)
    return kw.pop("k"), kw


def _solve_ea(edges, windows, sources, plan, n_vertices, init, kwargs, ladder):
    return _earliest_arrival_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=n_vertices,
        init=init, with_rounds=True, ladder=ladder, **kwargs)


def _solve_reach(edges, windows, sources, plan, n_vertices, init, kwargs, ladder):
    return _overlaps_reachability_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=n_vertices,
        init=init, ladder=ladder, **kwargs), -1


def _solve_pagerank(edges, windows, sources, plan, n_vertices, init, kwargs, ladder):
    # the ladder is a no-op for PageRank
    return temporal_pagerank_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, init=init, **kwargs), -1


def _solve_bfs(edges, windows, sources, plan, n_vertices, init, kwargs, ladder):
    return _temporal_bfs_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=n_vertices,
        init=init, ladder=ladder, **kwargs), -1


def _solve_cc(edges, windows, sources, plan, n_vertices, init, kwargs, ladder):
    return _temporal_cc_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, init=init, ladder=ladder,
        **kwargs), -1


def _solve_kcore(edges, windows, sources, plan, n_vertices, init, kwargs, ladder):
    k, kwargs = _require_k(kwargs)
    return _temporal_kcore_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, k=k, init=init,
        ladder=ladder, **kwargs), -1


def _solve_betweenness(edges, windows, sources, plan, n_vertices, init, kwargs, ladder):
    return _temporal_betweenness_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=n_vertices,
        init=init, ladder=ladder, **kwargs), -1


# ---- containment warm starts ----------------------------------------------

def _containment_spans(windows_new, prev_windows):
    """Span arrays, or None when no previous window can be STRICTLY
    contained in a new one (equal spans mean equality, which row matching
    already consumed: the steady sliding loop exits here)."""
    new_spans = windows_new[:, 1].astype(np.int64) - windows_new[:, 0]
    prev_spans = prev_windows[:, 1].astype(np.int64) - prev_windows[:, 0]
    if prev_spans.size == 0 or int(prev_spans.min()) >= int(new_spans.max()):
        return None
    return new_spans, prev_spans


def _best_contained(w, span, source, prev_windows, prev_spans, prev_sources):
    """Widest previous SAME-source row whose window is strictly contained
    in ``w`` (None if none); ``source`` None (source-free) matches any."""
    best, best_span = None, -1
    for p, wp in enumerate(prev_windows):
        if (prev_sources[p] == source and prev_spans[p] < span
                and wp[0] >= w[0] and wp[1] <= w[1]
                and int(prev_spans[p]) > best_span):
            best, best_span = p, int(prev_spans[p])
    return best


def _seeded_row(n_vertices, source, value, device):
    row = torch.full((n_vertices,), INT_INF, dtype=torch.int32, device=device)
    row[int(source)] = int(value)
    return row


def _ea_warm(new_sources, new_windows, prev_sources, prev_windows,
             prev_results, n_vertices):
    """[Qn, V] EA warm start: each new row seeded from a previous same-source
    row it strictly contains.  Labels witnessed inside the contained window
    stay witnessed and EA's min fixpoint is unique, so the warm run
    converges to the cold answer.  None when nothing is contained."""
    spans = _containment_spans(new_windows, prev_windows)
    if spans is None:
        return None
    new_spans, prev_spans = spans
    dev = prev_results.device
    rows, any_warm = [], False
    for s, w, span in zip(new_sources, new_windows, new_spans):
        cold = _seeded_row(n_vertices, s, w[0], dev)
        best = _best_contained(w, span, s, prev_windows, prev_spans, prev_sources)
        if best is None:
            rows.append(cold)
        else:
            any_warm = True
            rows.append(torch.minimum(cold, prev_results[best]))
    return torch.stack(rows) if any_warm else None


def _reach_warm(new_sources, new_windows, prev_sources, prev_windows,
                prev_results, n_vertices):
    """([Qn, V] end, [Qn, V] start) overlaps-reachability warm start from
    contained same-source rows: every warm pair is the last edge of a real
    chain inside the new window (sound; the witness pair may differ from a
    cold run's, hence opt-in)."""
    spans = _containment_spans(new_windows, prev_windows)
    if spans is None:
        return None
    new_spans, prev_spans = spans
    reach_p, start_p, end_p = prev_results
    dev = end_p.device
    e_rows, s_rows, any_warm = [], [], False
    for s, w, span in zip(new_sources, new_windows, new_spans):
        ce = _seeded_row(n_vertices, s, w[0], dev)
        cs = _seeded_row(n_vertices, s, w[0], dev)
        best = _best_contained(w, span, s, prev_windows, prev_spans, prev_sources)
        if best is None:
            e_rows.append(ce)
            s_rows.append(cs)
        else:
            any_warm = True
            pe = torch.where(reach_p[best], end_p[best], INT_INF)
            ps = torch.where(reach_p[best], start_p[best], INT_INF)
            better = (pe < ce) | ((pe == ce) & (ps < cs))
            e_rows.append(torch.where(better, pe, ce))
            s_rows.append(torch.where(better, ps, cs))
    if not any_warm:
        return None
    return torch.stack(e_rows), torch.stack(s_rows)


def _cc_warm(new_sources, new_windows, prev_sources, prev_windows,
             prev_results, n_vertices):
    """[Qn, V] hash-min label warm start from contained rows: a contained
    window's components are sub-components of the new window's, so its
    labels bound each sub-component's minimum and min-label propagation
    converges to the cold answer (exact).  Other rows start from identity
    labels."""
    spans = _containment_spans(new_windows, prev_windows)
    if spans is None:
        return None
    new_spans, prev_spans = spans
    base = torch.arange(n_vertices, dtype=torch.int32, device=prev_results.device)
    rows, any_warm = [], False
    for s, w, span in zip(new_sources, new_windows, new_spans):
        best = _best_contained(w, span, s, prev_windows, prev_spans, prev_sources)
        if best is None:
            rows.append(base)
        else:
            any_warm = True
            rows.append(prev_results[best])
    return torch.stack(rows) if any_warm else None


def _b_kcore(g, s, w, t, plan, kw):
    k, kw = _require_k(kw)
    return temporal_kcore_batched(g, k, w, t, plan=plan, **kw)


def _s_kcore(g, s, w, t, plan, kw):
    k, kw = _require_k(kw)
    return temporal_kcore(g, k, w, t, plan=plan, **kw)


_ALGOS = {
    "earliest_arrival": _Algo(
        _solve_ea,
        lambda g, s, w, t, plan, kw: earliest_arrival_batched(g, s, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: earliest_arrival(g, s, w, t, plan=plan, **kw),
        1, False, _ea_warm),
    "reachability": _Algo(
        _solve_reach,
        lambda g, s, w, t, plan, kw: overlaps_reachability_batched(
            g, s, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: overlaps_reachability(g, s, w, t, plan=plan, **kw),
        3, False, _reach_warm),
    "pagerank": _Algo(
        _solve_pagerank,
        lambda g, s, w, t, plan, kw: temporal_pagerank_batched(g, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: temporal_pagerank(g, w, t, plan=plan, **kw),
        1, True, None),
    "bfs": _Algo(
        _solve_bfs,
        lambda g, s, w, t, plan, kw: temporal_bfs_batched(g, s, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: temporal_bfs(g, s, w, t, plan=plan, **kw),
        2, False, None),
    "cc": _Algo(
        _solve_cc,
        lambda g, s, w, t, plan, kw: temporal_cc_batched(g, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: temporal_cc(g, w, t, plan=plan, **kw),
        1, True, _cc_warm),
    "kcore": _Algo(_solve_kcore, _b_kcore, _s_kcore, 1, True, None),
    "betweenness": _Algo(
        _solve_betweenness,
        lambda g, s, w, t, plan, kw: temporal_betweenness_batched(
            g, s, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: temporal_betweenness(g, [s], w, t, plan=plan, **kw),
        1, False, None),
}

ALGORITHMS = tuple(_ALGOS)


def _algo(algorithm: str) -> _Algo:
    try:
        return _ALGOS[algorithm]
    except KeyError:
        raise ValueError(
            f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}") from None


def sliding_windows(t_end: int, width: int, stride: int, count: int) -> np.ndarray:
    """``count`` windows of ``width`` ending at ``t_end``, sliding back by
    ``stride`` — windows[0] is the most recent.  Returns i32[count, 2]."""
    if count <= 0 or width <= 0 or stride <= 0:
        raise ValueError("count, width and stride must be positive")
    ends = t_end - stride * np.arange(count, dtype=np.int64)
    wins = np.stack([ends - width, ends], axis=1)
    return wins.astype(np.int32)


def _windows_and_plan(g, tger, windows, plan, access, backend):
    windows = to_numpy(windows).astype(np.int32).reshape(-1, 2)
    if plan is None:
        plan = plan_query(g, tger, windows=windows, access=access, backend=backend)
    return windows, plan


def sweep(
    g: TemporalGraph,
    source,
    windows,
    tger: Optional[TGERIndex] = None,
    *,
    algorithm: str = "earliest_arrival",
    access: str = "auto",
    backend: str = "xla_segment",
    plan: Optional[AccessPlan] = None,
    **kwargs,
):
    """Answer one query over W windows in a single batched execution.

    Returns [W, V], or a tuple of [W, V] tensors for the multi-output
    algorithms (reachability, bfs).  ``plan`` defaults to the union-window
    plan whose budgets cover every member window.  ``source`` is ignored by
    the source-free algorithms (pagerank, cc, kcore); kcore needs ``k=``."""
    entry = _algo(algorithm)
    windows, plan = _windows_and_plan(g, tger, windows, plan, access, backend)
    return entry.batched(g, source, windows, tger, plan, kwargs)


def sweep_looped(
    g: TemporalGraph,
    source,
    windows,
    tger: Optional[TGERIndex] = None,
    *,
    algorithm: str = "earliest_arrival",
    access: str = "auto",
    backend: str = "xla_segment",
    plan: Optional[AccessPlan] = None,
    **kwargs,
):
    """Reference execution: W independent single-window runs under the SAME
    union plan.  Returns the same [W, ...] stacking as :func:`sweep`."""
    entry = _algo(algorithm)
    windows, plan = _windows_and_plan(g, tger, windows, plan, access, backend)
    rows = [entry.single(g, source, (int(w[0]), int(w[1])), tger, plan, kwargs)
            for w in windows]
    if entry.n_outputs > 1:
        return tuple(torch.stack([r[i] for r in rows]) for i in range(entry.n_outputs))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# incremental serving
# ---------------------------------------------------------------------------

# Every device-work site of the incremental path notes a tag ("cold:view",
# "cold:solve", "reorder", "warm-init", "fused:<method>") into each log
# that ``dispatch_log`` opened (``obs.note``); a steady-state advance notes
# exactly one "fused:<method>", however many tenants the batch carries.
# Under a profiler session an advance records the spans ``serve.advance``
# (the root), ``serve.match``, ``serve.schedule``, ``serve.ring``,
# ``serve.view``, ``serve.solve.<algorithm>`` (each group's) and
# ``serve.assemble``.  The root, the ring write, the view and the solves
# also record their device extent; matching and scheduling are host work,
# and a CUDA event pair costs about 38 us on the host under the profiler.

@dataclasses.dataclass
class SweepState:
    """The carry between consecutive incremental advances: the answered
    (algorithm x source x window) rows, bucketed into (algorithm, params)
    groups, their [Q, V] answers (row reuse), the ring-buffer union view
    shared by every tenant (positionally stable across advances) and the
    host position bookkeeping of its delta writes.

    ``last_advance`` says how the view was obtained: ``cold`` (plan and
    ring built anew), ``delta`` (ring advanced in place; index and hybrid),
    ``reuse`` (scan view, untouched), ``noop`` / ``reorder`` (row set
    unchanged / permuted); ``n_solved`` counts the rows that ran a fixpoint
    and ``n_solved_unique`` those left after cross-tenant dedup.

    Passing a state to a delta or reuse advance CONSUMES it: its ring
    tensors are written in place (the counterpart of the JAX package's
    buffer donation), and passing it again raises.  Result tensors already
    returned stay valid."""

    group_keys: tuple            # ((algorithm, params_token), ...) per group
    group_sources: tuple         # per group: tuple of source ids (None = source-free)
    group_windows: tuple         # per group: i32[Qg, 2] (host)
    plan: AccessPlan
    edges: EdgeView              # ring-layout union view (device)
    union: Tuple[int, int]
    lo: int                      # first resident time-first position (index:
                                 # global order; hybrid: heavy order; -1 scan)
    hi: int                      # end of the valid position range [lo, hi)
    capacity: int                # ring slot count C (0 for scan)
    results: tuple               # per-group [Qg, V] tensor / tuple (device)
    graph_ref: Any               # the graph's src tensor: identity of the graph
    last_advance: str = "cold"
    n_solved: int = 0
    warm_applied: bool = False   # an explicit warm_start= actually seeded rows
    last_rounds: Any = None      # EA groups' round counts (host ints)
    mesh: Any = None             # serving DeviceMesh of a sharded stream
    n_solved_unique: int = 0     # rows that ran a fixpoint after dedup
    group_caps: tuple = ()       # per-group BUCKETED row capacity (empty =
                                 # exact-shape schedule mode)
    last_schedule: Any = None    # schedule of the last fused advance (None
                                 # after cold/noop/reorder)
    # The port's own field, after all of the reference's: a later advance
    # took this state's buffers.
    consumed: bool = False

    @property
    def algorithm(self) -> str:
        """The algorithm of a single-group state (an error on multi-group
        states)."""
        if len(self.group_keys) != 1:
            raise ValueError("algorithm is ambiguous on a multi-group state")
        return self.group_keys[0][0]

    @property
    def windows(self) -> np.ndarray:
        """i32[W, 2] windows of a single-group state."""
        if len(self.group_keys) != 1:
            raise ValueError("windows is ambiguous on a multi-group state")
        return self.group_windows[0]


def _assemble(prev, sub, row_map, new_pos, n_outputs: int):
    """Row assembly: reused rows gathered from the previous results, the
    freshly solved rows written into their positions."""
    rm = torch.as_tensor(row_map, dtype=torch.int64)
    npos = torch.as_tensor(new_pos, dtype=torch.int64)

    def one(p, s):
        out = p[rm.to(p.device)]
        out[npos.to(p.device)] = s
        return out

    if n_outputs == 1:
        return one(prev, sub)
    return tuple(one(prev[i], sub[i]) for i in range(n_outputs))


def _gather_rows(prev, row_map, n_outputs: int):
    """Reused-rows-only groups: a gather, or the tensors untouched when the
    map is the full identity of the previous rows (a strict prefix has an
    identity map but must drop the trailing rows)."""
    n_prev = prev.shape[0] if n_outputs == 1 else prev[0].shape[0]
    if len(row_map) == n_prev and row_map == tuple(range(len(row_map))):
        return prev
    if n_outputs == 1:
        return prev[torch.as_tensor(row_map, dtype=torch.int64, device=prev.device)]
    rm = torch.as_tensor(row_map, dtype=torch.int64, device=prev[0].device)
    return tuple(p[rm] for p in prev)


def _gather_solved(sub, solve_map, n_outputs: int):
    """Dedup fan-out: the solved unique rows mapped back onto the full
    new-row axis."""
    first = sub if n_outputs == 1 else sub[0]
    sm = torch.as_tensor(solve_map, dtype=torch.int64, device=first.device)
    if n_outputs == 1:
        return sub[sm]
    return tuple(s[sm] for s in sub)


def _place_ring(edges, mesh):
    """The ring view under a serving mesh: whole on every rank of a 1-D
    query mesh; on a 2-D edge x query mesh each rank keeps its edge
    coordinate's contiguous slot chunk, so edge rank e owns global slots
    [e*C/E, (e+1)*C/E) and the positionally stable slot order is the shard
    boundary."""
    e_sh, _ = mesh_shape(mesh)
    if e_sh == 1:
        return replicate(edges, mesh)
    C = edges.src.shape[0]
    if C % e_sh:
        raise ValueError(
            f"ring capacity {C} does not divide across {e_sh} edge shards: "
            f"capacity rungs are powers of two, so use a power-of-two "
            f"edge-shard count")
    ax = mesh_axis(mesh, mesh.mesh_dim_names[0])
    c = C // e_sh
    return EdgeView(*(t[ax.index * c:(ax.index + 1) * c].clone() for t in edges))


def _edge_plan(plan, mesh):
    """``plan`` with its edge axis set when ``mesh`` shards the edges."""
    if mesh is None or len(mesh.mesh_dim_names) < 2:
        return plan
    return dataclasses.replace(plan, edge_axis=mesh_axis(mesh, mesh.mesh_dim_names[0]))


def _take_rows(x, sl):
    return tuple(a[sl] for a in x) if isinstance(x, tuple) else x[sl]


def _solve_rows_sharded(entry, params, plan, n_vertices, mesh, edges, windows,
                        sources, init):
    """One group's new-row solve with the (padded) row axis sharded over the
    mesh's query dimension: this rank solves only its contiguous row chunk,
    under its own convergence loop (a rank whose rows settle early stops
    early), then the chunks are all-gathered along the query dimension, so
    every rank holds every solved row.

    Under a 2-D edge x query mesh the view is this rank's slot chunk and the
    plan's ``edge_axis`` makes every combine end with one collective across
    the edge dimension.  The post-collective state is the same on every
    edge rank of a row chunk, so they run the same rounds in lockstep while
    the query dimension keeps local convergence.  ``last_rounds`` is the
    max over the query dimension."""
    row_ax = mesh_axis(mesh, mesh.mesh_dim_names[-1])
    cap = windows.shape[0] // row_ax.size
    sl = slice(row_ax.index * cap, (row_ax.index + 1) * cap)
    sub, rounds = entry.solve(
        edges, windows[sl], None if sources is None else sources[sl],
        _edge_plan(plan, mesh), n_vertices,
        None if init is None else _take_rows(init, sl), dict(params), False)
    subs = tuple(all_gather(x, row_ax)
                 for x in (sub if isinstance(sub, tuple) else (sub,)))
    if rounds >= 0:
        # only EA counts its rounds (the rest report -1 on every rank); the
        # read is one more host sync after the loop's own
        r = torch.tensor([rounds], dtype=torch.int32, device=subs[0].device)
        rounds = int(all_reduce(r, "max", row_ax)[0])
        obs.count("host_reads")
    return (subs[0] if entry.n_outputs == 1 else subs), rounds


def _solve_groups(edges, plan, n_vertices, schedule, prev_results,
                  new_windows, new_sources, inits, maps=None, mesh=None):
    """Every group's solve (of only its genuinely new rows) and row
    assembly over the just-advanced view.  ``schedule`` holds (algorithm,
    params, row_map, new_pos, solve_map) per group; ``solve_map`` (None =
    identity) fans the deduplicated solved rows out onto the new rows.
    The solves are dense: in the JAX package this advance is one traced
    program, where the ladder never engages.

    A group may instead carry a BUCKETED entry ``(algorithm, params,
    "bucket", cap, n_new_cap)`` (the admission ladder): its row map is a
    dynamic int32[cap] tensor in ``maps`` rather than a schedule field, so
    the schedule keys only the padded capacities and a tenant admitted or
    retired inside the bucket changes no shape.  Assembly is one gather
    over the concatenated (previous buffer ‖ freshly solved) row pool; pad
    slots replicate the last real row.

    With a ``mesh`` every group's solve row-shards over its query dimension
    (:func:`_solve_rows_sharded`)."""

    def solve(algorithm, entry, params, gi):
        with obs.span(f"serve.solve.{algorithm}", stage=True):
            if mesh is not None:
                return _solve_rows_sharded(entry, params, plan, n_vertices, mesh,
                                           edges, new_windows[gi], new_sources[gi],
                                           inits[gi])
            return entry.solve(edges, new_windows[gi], new_sources[gi], plan,
                               n_vertices, inits[gi], dict(params), False)

    out, rounds_out = [], []
    for gi, entry_s in enumerate(schedule):
        algorithm, params = entry_s[0], entry_s[1]
        entry = _ALGOS[algorithm]
        prev = prev_results[gi]
        if entry_s[2] == "bucket":
            prevs = prev if isinstance(prev, tuple) else (prev,)
            if entry_s[4]:
                sub, rounds = solve(algorithm, entry, params, gi)
                subs = sub if isinstance(sub, tuple) else (sub,)
            else:
                rounds, subs = -1, None
            with obs.span("serve.assemble"):
                pool = prevs if subs is None else subs if prev is None else tuple(
                    torch.cat([p, s]) for p, s in zip(prevs, subs))
                picked = tuple(p[maps[gi]] for p in pool)
            out.append(picked[0] if entry.n_outputs == 1 else picked)
            rounds_out.append(rounds)
            continue
        row_map, new_pos, solve_map = entry_s[2], entry_s[3], entry_s[4]
        if new_pos:
            sub, rounds = solve(algorithm, entry, params, gi)
            with obs.span("serve.assemble"):
                if solve_map is not None:
                    sub = _gather_solved(sub, solve_map, entry.n_outputs)
                res = sub if prev is None else _assemble(
                    prev, sub, row_map, new_pos, entry.n_outputs)
        else:
            with obs.span("serve.assemble"):
                res = _gather_rows(prev, row_map, entry.n_outputs)
            rounds = -1
        out.append(res)
        rounds_out.append(rounds)
    return tuple(out), tuple(rounds_out)


_ADVANCE_RING = {
    "index": advance_index_ring_fields,
    "hybrid": advance_hybrid_ring_fields,
}


def _advance_ring_sharded(mesh, fields, perm, edges: EdgeView, lo_prev: int,
                          lo_new: int, hi_new: int, *, capacity: int) -> EdgeView:
    """Edge-sharded index-ring delta advance, in place: edge rank e owns the
    slot chunk [e*C/E, (e+1)*C/E), so of the entering positions it writes
    only those whose slot ``p mod C`` is its own, at the local slot, and
    recomputes its chunk of the validity mask.  Per slot this equals the
    unsharded ``advance_index_ring_fields``: the slot of a position does not
    depend on the layout, the chunking only decides which rank holds it."""
    ax = mesh_axis(mesh, mesh.mesh_dim_names[0])
    c_local = capacity // ax.size
    base = ax.index * c_local
    dev = edges.src.device
    enter = _entering(lo_prev, lo_new, capacity, dev)
    gslot = torch.remainder(enter, capacity)
    mine = (gslot >= base) & (gslot < base + c_local)
    _scatter_entering(fields, perm, edges, enter[mine], gslot[mine] - base)
    edges.mask.copy_(
        ring_positions(lo_new, capacity, dev)[base:base + c_local] < int(hi_new))
    return edges


# ---------------------------------------------------------------------------
# the shared advance engine
# ---------------------------------------------------------------------------

def _match_rows(new_sources, new_windows, prev_sources, prev_windows):
    """(source, window) row matching within one group: per new row, the
    index of an equal previous row, or None (the row needs solving)."""
    if len(prev_sources) == 0:
        return [None] * len(new_sources)
    eq = (new_windows[:, None, :] == prev_windows[None, :, :]).all(axis=2)
    src_set = set(new_sources)
    if not (src_set == set(prev_sources) and len(src_set) == 1):
        ns = np.asarray([-1 if s is None else s for s in new_sources])
        ps = np.asarray([-1 if s is None else s for s in prev_sources])
        eq &= ns[:, None] == ps[None, :]
    has = eq.any(axis=1)
    arg = eq.argmax(axis=1)
    return [int(arg[i]) if has[i] else None for i in range(len(new_sources))]


def _plan_covers(g, tger, p: AccessPlan, union) -> bool:
    """May a cold fallback keep the previous plan (and its ring capacity)
    for this union?  Replan only when coverage lapsed."""
    if p.method == "scan":
        return True
    if tger is None:
        return False
    if p.method == "index":
        lo, hi = window_positions_host(tger, union)
        return hi - lo <= (p.ring_capacity or p.budget)
    lo, hi = heavy_window_positions_host(tger, union)
    if p.ring_capacity and hi - lo > p.ring_capacity:
        return False
    return per_vertex_window_budget(g, tger, union) <= p.per_vertex_budget


def _group_warm(key, warm_start, new_sources, new_windows, prev, n_vertices):
    """The explicit ``warm_start=`` gate: EA and cc warm starts are exact,
    reachability's sound; bfs (round-indexed hops), pagerank (finite
    iterations), kcore (peeling cannot resurrect) and betweenness (not a
    monotone fixpoint) are refused, as is EA under ``visit_once``.  The
    caller sees refusals in ``state.warm_applied``."""
    algorithm, params = key
    entry = _ALGOS[algorithm]
    if not warm_start or entry.warm is None or prev is None:
        return None
    if algorithm == "earliest_arrival" and dict(params).get("visit_once"):
        return None  # visited-blocking breaks re-expansion: unsound
    prev_sources, prev_windows, prev_results = prev
    return entry.warm(new_sources, new_windows, prev_sources, prev_windows,
                      prev_results, n_vertices)


def _sources_tensor(sources, device):
    return torch.as_tensor(np.asarray(sources, np.int64), device=device)


def _advance(
    g: TemporalGraph,
    tger: Optional[TGERIndex],
    groups,                 # [(key, sources list, i32[Qg, 2] windows), ...]
    state: Optional[SweepState],
    *,
    plan_arg: Optional[AccessPlan],
    plan_builder: Callable[[], AccessPlan],
    warm_start: bool,
    mesh=None,
    bucketed: bool = False,
    bucket_headroom: int = 0,
    coldstore=None,
    tier: str = "hot",
):
    """The incremental advance shared by ``serve_batch`` and
    ``sweep_incremental``: match every group's rows against the carried
    state, then answer everything in one advance (ring delta + per-group
    solves + row assembly), falling back to a cold plan + build + solve only
    when coverage forces it.

    ``bucketed=True`` is the admission-ladder mode the serving daemon
    drives: every group's result buffer is PADDED to its power-of-two
    :func:`~repro_torch.engine.queries.bucket_capacity` (pad slots
    replicate the last real row) and the schedule carries only the padded
    capacities; row assignment travels as dynamic int32[cap] gather maps.

    ``coldstore`` seals the positions an index ring evicts (after the
    advance's device work is enqueued); ``tier`` other than ``"hot"``
    stitches the view from the store instead of building it on the
    device.

    With a serving ``mesh`` the ring is placed once at the cold build
    (whole, or this rank's slot chunk on a 2-D mesh), the cold solves run
    every row on every rank (with the edge collectives on a 2-D mesh, as
    the reference solves its cold rows over the globally sharded ring), and
    an advance row-shards every group's new rows over the query
    dimension."""
    if state is not None and state.consumed:
        raise RuntimeError(
            "this SweepState was consumed by an earlier advance: its ring "
            "buffers were written in place (moved-from, as if deleted); pass "
            "the state that advance returned")
    union = (
        min(int(w[:, 0].min()) for _, _, w in groups),
        max(int(w[:, 1].max()) for _, _, w in groups),
    )
    n_rows_total = sum(len(s) for _, s, _ in groups)
    dev = g.device
    e_sh, d_sh = mesh_shape(mesh)

    caps: tuple = ()
    if bucketed:
        prev_caps = ({} if state is None
                     else dict(zip(state.group_keys, state.group_caps)))
        # the headroom (the daemon's arrival forecast) sizes the bucket for
        # the rows expected next tick; the 4x shrink hysteresis applies on top
        caps = tuple(
            bucket_capacity(len(s) + max(0, int(bucket_headroom)),
                            prev_caps.get(key, 0))
            for key, s, _ in groups)

    def freeze(plan, edges, lo, hi, capacity, results, advance, n_solved,
               warm_applied, rounds, n_unique=0, last_schedule=None):
        return SweepState(
            group_keys=tuple(k for k, _, _ in groups),
            group_sources=tuple(tuple(s) for _, s, _ in groups),
            group_windows=tuple(w.copy() for _, _, w in groups),
            plan=plan, edges=edges, union=union, lo=lo, hi=hi,
            capacity=capacity, results=results, graph_ref=g.src,
            last_advance=advance, n_solved=n_solved, warm_applied=warm_applied,
            last_rounds=rounds[0] if len(rounds) == 1 else tuple(rounds),
            n_solved_unique=n_unique, group_caps=caps,
            last_schedule=last_schedule, mesh=mesh,
        )

    def cold(prev_plan=None):
        p = plan_arg
        if p is None and prev_plan is not None and _plan_covers(
                g, tger, prev_plan, union):
            p = prev_plan
        if p is None:
            p = plan_builder()
        if tier != "hot":
            # the view is stitched on the host from the cold store's chunks
            # (plus the mirrors' pending tail and a split window's hot
            # suffix) in index-ring slot order, so every solve below equals
            # a cold index build under the same plan; the carried hot ring
            # is never consumed
            with obs.span("serve.view", stage=True):
                obs.note("cold:stitch")
                capacity = p.ring_capacity or p.budget
                fields_np, mask_np, lo, hi = coldstore.ring_stitch(union, capacity)
                edges = EdgeView(*(torch.from_numpy(a).to(dev) for a in fields_np),
                                 torch.from_numpy(mask_np).to(dev))
        else:
            with obs.span("serve.view", stage=True):
                obs.note("cold:view")
                edges, lo, hi, capacity = ring_view_for_plan(g, tger, union, p)
            if coldstore is not None and p.method == "index" and lo > 0:
                # everything below the fresh ring's low watermark is
                # history: seal it (host work; the first note backfills
                # from position 0)
                coldstore.note_eviction(lo)
        if mesh is not None and p.method != "scan":
            # placed once at the cold build; the scan view aliases the
            # graph's own arrays and is never written
            with obs.span("serve.view", stage=True):
                edges = _place_ring(edges, mesh)
        p_solve = _edge_plan(p, mesh)
        results, rounds, n_unique = [], [], 0
        for gi, (key, sources, wins) in enumerate(groups):
            entry = _ALGOS[key[0]]
            obs.note("cold:solve")
            u_sources, u_windows, inverse = dedup_rows(sources, wins)
            n_unique += len(u_sources)
            src_dev = None if entry.source_free else _sources_tensor(u_sources, dev)
            with obs.span(f"serve.solve.{key[0]}", stage=True):
                res, rnd = entry.solve(edges, u_windows, src_dev, p_solve, g.n_vertices,
                                       None, dict(key[1]), ladder_eligible(p_solve))
            out_map = tuple(inverse)
            if bucketed:
                # pad to the bucket capacity with the last real row (a pad
                # row IS a real row; the daemon slices it off)
                out_map += (out_map[-1],) * (caps[gi] - len(out_map))
            if out_map != tuple(range(len(u_sources))):
                with obs.span("serve.assemble"):
                    res = _gather_solved(res, out_map, entry.n_outputs)
            results.append(res)
            rounds.append(rnd)
        return tuple(results), freeze(
            p, edges, lo, hi, capacity, tuple(results), "cold", n_rows_total,
            False, rounds, n_unique=n_unique)

    if state is None:
        return cold()
    p = state.plan

    # ---- match rows against the previous advance's answered groups --------
    with obs.span("serve.match"):
        prev_idx = {key: i for i, key in enumerate(state.group_keys)}
        matched = []                # per group: list of prev-row idx | None
        for key, sources, wins in groups:
            pi = prev_idx.get(key)
            if pi is None:
                matched.append([None] * len(sources))
            else:
                matched.append(_match_rows(sources, wins, state.group_sources[pi],
                                           state.group_windows[pi]))
        total_new = sum(sum(m is None for m in ms) for ms in matched)

    if total_new == 0:
        # noop only when every group's rows are the FULL identity of the
        # previous group's rows; a strict prefix takes the reorder gather
        identical = (
            tuple(k for k, _, _ in groups) == state.group_keys
            and all(ms == list(range(len(state.group_sources[pi])))
                    for pi, ms in enumerate(matched))
        )
        if identical:
            return state.results, dataclasses.replace(
                state, last_advance="noop", n_solved=0, warm_applied=False,
                n_solved_unique=0, last_schedule=None)
        # a permutation of answered rows (bucketed: padded back out to the
        # possibly hysteresis-shrunk bucket capacity)
        obs.note("reorder")
        results = []
        with obs.span("serve.assemble"):
            for gi, ((key, _, _), ms) in enumerate(zip(groups, matched)):
                mm = tuple(ms)
                if bucketed:
                    mm += (mm[-1],) * (caps[gi] - len(mm))
                results.append(_gather_rows(state.results[prev_idx[key]], mm,
                                            _ALGOS[key[0]].n_outputs))
        results = tuple(results)
        return results, freeze(
            p, state.edges, state.lo, state.hi, state.capacity, results,
            "reorder", 0, False, [-1] * len(groups))

    if tier != "hot" or p.tier != "hot":
        # tier serves never delta-advance (historical windows do not slide)
        # and a tier switch never consumes the carried hot state: fall cold,
        # keeping the previous plan only within its own tier
        return cold(prev_plan=p if p.tier == tier else None)

    def build_schedule():
        schedule, prev_results, new_windows, new_sources, inits = [], [], [], [], []
        any_warm, n_unique = False, 0
        for (key, sources, wins), ms in zip(groups, matched):
            entry = _ALGOS[key[0]]
            new_idx = [i for i, m in enumerate(ms) if m is None]
            row_map = tuple(0 if m is None else m for m in ms)
            pi = prev_idx.get(key)
            prev_res = None if pi is None else state.results[pi]
            solve_map = None
            if new_idx:
                # cross-tenant dedup: identical (source, window) rows solve
                # once; solve_map fans them back out at assembly
                u_sources, u_windows, inverse = dedup_rows(
                    [sources[i] for i in new_idx], wins[new_idx])
                n_unique += len(u_sources)
                prev = None if pi is None else (
                    state.group_sources[pi], state.group_windows[pi],
                    state.results[pi])
                init = _group_warm(key, warm_start, u_sources, u_windows, prev,
                                   g.n_vertices)
                any_warm |= init is not None
                if mesh is not None:
                    # pad-and-mask row partition over the QUERY dimension
                    # (the edge dimension replicates rows): real row j keeps
                    # index j, so ``inverse`` also drops the padding
                    _, pad_map = row_partition(len(u_sources), d_sh)
                    u_windows = u_windows[pad_map]
                    u_sources = [u_sources[j] for j in pad_map]
                    if init is not None:
                        init = _take_rows(init, torch.as_tensor(
                            pad_map, dtype=torch.int64, device=dev))
                if inverse != tuple(range(len(u_sources))):
                    solve_map = inverse
                new_windows.append(u_windows)
                new_sources.append(
                    None if entry.source_free else _sources_tensor(u_sources, dev))
                inits.append(init)
            else:
                new_windows.append(None)
                new_sources.append(None)
                inits.append(None)
            schedule.append((key[0], key[1], row_map, tuple(new_idx), solve_map))
            prev_results.append(prev_res)
        if any_warm:
            obs.note("warm-init")
        return (tuple(schedule), tuple(prev_results), tuple(new_windows),
                tuple(new_sources), tuple(inits), None, any_warm, n_unique)

    def build_schedule_bucketed():
        """The admission-ladder schedule: each entry is ``(algorithm,
        params, "bucket", cap, K)``, only the padded bucket capacity and the
        solve capacity static.  Row assignment travels as a dynamic
        int32[cap] gather map over the (previous padded buffer ‖ freshly
        solved rows) pool, so admitting or retiring a tenant inside the
        bucket keeps every shape."""
        schedule, prev_results, new_windows, new_sources, inits, maps = \
            [], [], [], [], [], []
        n_unique = 0
        for gi, ((key, sources, wins), ms) in enumerate(zip(groups, matched)):
            entry = _ALGOS[key[0]]
            cap = caps[gi]
            pi = prev_idx.get(key)
            prev_res = None if pi is None else state.results[pi]
            if pi is not None and state.group_caps[pi] != cap:
                # bucket transition: re-pad the carried buffer to the NEW
                # capacity (one gather, only when the bucket itself changes)
                needed = sorted({m for m in ms if m is not None}) or [0]
                remap = {m: j for j, m in enumerate(needed)}
                rm = tuple(needed) + (needed[-1],) * (cap - len(needed))
                obs.note("rebucket")
                prev_res = _gather_rows(prev_res, rm, entry.n_outputs)
                ms = [None if m is None else remap[m] for m in ms]
            new_idx = [i for i, m in enumerate(ms) if m is None]
            inverse: tuple = ()
            K = 0
            if new_idx:
                u_sources, u_windows, inverse = dedup_rows(
                    [sources[i] for i in new_idx], wins[new_idx])
                m_u = len(u_sources)
                n_unique += m_u
                # the new-row solve pads to the FULL bucket capacity, so
                # churn inside the bucket never changes the solve's shape
                K = cap
                if mesh is not None:
                    # bucket-aligned partition: each rank's chunk snaps up to
                    # the bucket ladder value of ceil(cap / D), so chunk
                    # boundaries land on bucket multiples (K == cap for a
                    # power-of-two D <= cap)
                    chunk, _ = row_partition(
                        cap, d_sh, align=bucket_capacity(-(-cap // d_sh)))
                    K = chunk * d_sh
                if K != m_u:
                    pad_map = list(range(m_u)) + [m_u - 1] * (K - m_u)
                    u_windows = u_windows[pad_map]
                    u_sources = [u_sources[j] for j in pad_map]
                new_windows.append(np.ascontiguousarray(u_windows))
                new_sources.append(
                    None if entry.source_free else _sources_tensor(u_sources, dev))
            else:
                new_windows.append(None)
                new_sources.append(None)
            inits.append(None)      # warm starts are refused in bucketed mode
            offset = 0 if pi is None else cap
            pos = {i: j for j, i in enumerate(new_idx)}
            sel = [m if m is not None else offset + inverse[pos[i]]
                   for i, m in enumerate(ms)]
            sel.extend([sel[-1]] * (cap - len(sel)))
            maps.append(torch.as_tensor(np.asarray(sel, np.int32), device=dev))
            schedule.append((key[0], key[1], "bucket", cap, K))
            prev_results.append(prev_res)
        return (tuple(schedule), tuple(prev_results), tuple(new_windows),
                tuple(new_sources), tuple(inits), tuple(maps), False, n_unique)

    def built():
        with obs.span("serve.schedule"):
            return (build_schedule_bucketed if bucketed else build_schedule)()
    fields = (g.src, g.dst, g.t_start, g.t_end, g.weight)
    if mesh is not None:
        fields = replicated_arrays(mesh, *fields)
    shard_tag = ("" if mesh is None
                 else f"@q{d_sh}" if e_sh == 1 else f"@e{e_sh}q{d_sh}")

    if p.method == "scan":
        (schedule, prev_results, new_windows, new_sources, inits, maps,
         any_warm, n_unique) = built()
        obs.note(f"fused:scan{shard_tag}")
        state.consumed = True
        # the scan "ring" is the graph's own arrays: solved over, never written
        results, rounds = _solve_groups(state.edges, p, g.n_vertices, schedule,
                                        prev_results, new_windows, new_sources,
                                        inits, maps, mesh=mesh)
        return results, freeze(
            p, state.edges, -1, -1, 0, results, "reuse", total_new, any_warm,
            rounds, n_unique=n_unique, last_schedule=schedule)

    if p.method in ("index", "hybrid") and tger is not None:
        positions = (window_positions_host if p.method == "index"
                     else heavy_window_positions_host)
        lo_new, hi_new = positions(tger, union)
        # hybrid parity guard: a cold hybrid_view under this plan would
        # truncate if some vertex's in-window count outgrew the per-vertex
        # budget, so replan (the total heavy count bounds each vertex's)
        if (p.method == "hybrid"
                and hi_new - lo_new > p.per_vertex_budget
                and per_vertex_window_budget(g, tger, union) > p.per_vertex_budget):
            return cold()
        shift = lo_new - state.lo
        C = state.capacity
        if shift < 0 or shift > C or hi_new - lo_new > C:
            # slid backwards or the ring no longer covers
            return cold(prev_plan=p)
        perm = (tger.perm_by_start if p.method == "index"
                else tger.heavy_perm_by_start)
        if mesh is not None:
            (perm,) = replicated_arrays(mesh, perm)
        (schedule, prev_results, new_windows, new_sources, inits, maps,
         any_warm, n_unique) = built()
        obs.note(f"fused:{p.method}{shard_tag}")
        state.consumed = True
        # the entering positions are written into the carried ring in place
        # (on a 2-D mesh only by the rank that owns their slots)
        with obs.span("serve.ring", stage=True):
            if e_sh > 1:
                edges = _advance_ring_sharded(mesh, fields, perm, state.edges,
                                              state.lo, lo_new, hi_new, capacity=C)
            else:
                edges = _ADVANCE_RING[p.method](fields, perm, state.edges, state.lo,
                                                lo_new, hi_new, capacity=C)
        results, rounds = _solve_groups(edges, p, g.n_vertices, schedule,
                                        prev_results, new_windows, new_sources,
                                        inits, maps, mesh=mesh)
        if coldstore is not None and p.method == "index":
            # compaction hook: after the advance's device work is enqueued,
            # the positions this slide evicted ([state.lo, lo_new)) seal on
            # the host from the store's own mirrors
            coldstore.note_eviction(lo_new)
        return results, freeze(
            p, edges, lo_new, hi_new, C, results, "delta", total_new, any_warm,
            rounds, n_unique=n_unique, last_schedule=schedule)

    return cold()


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

_SERVE_COMBOS = (
    "supported serve_batch combinations: mesh None | int D | (E, D) tuple | "
    "DeviceMesh (over the whole process group); admission None | "
    "'bucketed' (composes with any mesh shape); warm_start=True only with "
    "admission=None; edge-sharded meshes (E > 1) require the index access "
    "method (a TGER index and access='auto'|'index' / an index plan=); "
    "coldstore= (tiered history) requires a TGER, and a below-horizon "
    "(cold/split tier) batch additionally requires admission=None, "
    "warm_start=False, mesh=None"
)


def _serving_mesh(mesh, device):
    """A ``mesh=`` argument as a DeviceMesh on ``device``'s type: an int is
    a 1-D query mesh, an ``(E, D)`` tuple the 2-D edge x query mesh."""
    if mesh is None:
        return None
    if isinstance(mesh, (tuple, list)):
        mesh = serve_mesh(int(mesh[0]), int(mesh[1]), device=device)
    elif not hasattr(mesh, "mesh_dim_names"):
        mesh = query_mesh(int(mesh), device=device)
    if mesh.device_type != torch.device(device).type:
        raise ValueError(
            f"the mesh runs on {mesh.device_type!r} but the graph lives on "
            f"{torch.device(device).type!r}; " + _SERVE_COMBOS)
    return mesh


def _history_tier(tger, union, state, coldstore, plan_arg, access) -> str:
    """Classify the union window against the cold store's hot horizon.
    ``"hot"`` when tiering is off: no store, or a scan/hybrid access path
    (a scan view is never evicted; the hybrid ring re-rungs on coverage
    lapse), so only index plans route below the horizon.  A compatible
    carried hot index state's OWN ring low watermark is the horizon: a
    forward-sliding chain stays hot even after another chain pushed the
    store's global watermark past its lo."""
    if coldstore is None:
        return "hot"
    if tger is None:
        raise ValueError(
            "coldstore serving requires a TGER index (the time-first "
            "permutation is the compaction domain); " + _SERVE_COMBOS)
    if access in ("scan", "hybrid") or (plan_arg is not None
                                        and plan_arg.method != "index"):
        return "hot"
    hot_lo = coldstore.watermark
    if (state is not None and state.lo >= 0
            and state.plan.method == "index" and state.plan.tier == "hot"):
        hot_lo = state.lo
    return coldstore.classify(union, hot_lo=hot_lo)


def serve_batch(
    g: TemporalGraph,
    batch: QueryBatch,
    tger: Optional[TGERIndex] = None,
    *,
    state: Optional[SweepState] = None,
    access: str = "auto",
    backend: str = "xla_segment",
    plan: Optional[AccessPlan] = None,
    warm_start: bool = False,
    mesh: Optional[Any] = None,
    admission: Optional[str] = None,
    bucket_headroom: int = 0,
    coldstore=None,
    ladder: int = 0,
):
    """Serve a whole :class:`~repro_torch.engine.queries.QueryBatch`.

    Returns ``(results, state)``: ``results`` has one entry per
    (algorithm, params) GROUP of the batch (``batch.groups()`` order), each
    a [Q_g, V] tensor (or a tuple for reachability and bfs), rows in group
    row order.  Pass the returned state with the next batch: a steady-state
    advance (same batch shape, windows slid forward) writes only the
    entering time-first range into the carried ring, solves only the new
    rows of every group (identical rows across tenants solve once) and
    reuses the rest.  Integer-label rows are bit-identical to the
    corresponding cold single-query sweeps under the same plan; float rows
    match allclose.

    A state from another graph, from the other admission mode, or with an
    incompatible explicit ``plan`` falls back to a cold serve and is not
    consumed.  ``warm_start=True`` opts into the containment warm starts
    (EA and cc exact, reachability sound, refused elsewhere).

    ``admission="bucketed"`` is the admission ladder the serving daemon
    drives: every group's result buffer is PADDED to its power-of-two
    :func:`~repro_torch.engine.queries.bucket_capacity` (slice each group
    to ``len(batch.groups()[key])`` rows before reading), resident groups
    keep the carried state's schedule order (results still come back in
    THIS batch's group order), and row assignment rides dynamic gather
    maps, so tenant churn inside a bucket keeps every shape.
    ``bucket_headroom`` (the daemon's arrival forecast) sizes buckets for
    the rows expected next tick.  Bucketed admission refuses
    ``warm_start``.

    ``coldstore`` (a :class:`~repro_torch.core.coldstore.ColdStore`) opts
    into tiered history: every index advance and cold build seals the
    positions leaving the ring into the store (host work, after the
    advance's device work is enqueued).  A batch whose union window falls
    below the hot horizon (the carried ring's low watermark, else the
    store's) routes to the COLD TIER without consuming the hot chain: the
    view is stitched on the host from the chunks (tier ``"cold"``, or
    ``"split"`` across the horizon) and solved as usual, bit-identical to
    a cold full-history index solve under the same plan.  The cold tier
    takes only ``admission=None`` and ``warm_start=False``; scan and hybrid
    access ignore the store.  Every refused combination raises
    ``ValueError`` before any state is consumed.

    ``ladder`` sets the frontier-rung cap on the batch plan (it rides the
    cache key, so a chain keeps the ladder it cold-started with): the cold
    solves run through the frontier ladder (bit-identical rows), and a
    steady advance keeps its dense solves.  Edge-sharded solves ignore it.

    ``mesh`` opts into SHARDED serving over the process group: every rank
    calls ``serve_batch`` with the same arguments.  ``mesh=D`` (or a 1-D
    ``DeviceMesh`` over ``"model"``) partitions every group's new rows into
    D contiguous chunks, each rank solving its chunk under its own
    convergence loop, then all-gathers them, so every rank returns every
    row.  ``mesh=(E, D)`` (or a ``("data", "model")`` mesh) also splits the
    index ring into E slot chunks, the delta landing only on the owning
    rank, with one collective per combine across the edge dimension; it
    needs a TGER and the index method.  ``(1, D)`` is the 1-D mesh.
    Integer rows are bit-identical to the unsharded engine; float rows
    (pagerank, betweenness) cross a sum at E > 1 and match allclose.  A
    carried state is bound to its mesh: a serve under another mesh (or
    none) falls cold without consuming it.  A mesh whose size is not the
    process group's world size raises ``ValueError`` before any state is
    consumed."""
    if admission not in (None, "bucketed"):
        raise ValueError(f"unknown admission mode {admission!r}; " + _SERVE_COMBOS)
    mesh = _serving_mesh(mesh, g.device)
    e_sh, _ = mesh_shape(mesh)
    if e_sh > 1:
        # every check here fires before the carried state can be consumed
        if tger is None:
            raise ValueError(
                "an edge-sharded mesh (E > 1) requires a TGER index: the "
                "ring's slot chunks are the shard boundaries; " + _SERVE_COMBOS)
        if plan is not None and plan.method != "index":
            raise ValueError(
                f"an edge-sharded mesh (E > 1) requires an index plan, got "
                f"method={plan.method!r}; " + _SERVE_COMBOS)
        if access not in ("auto", "index"):
            raise ValueError(
                f"an edge-sharded mesh (E > 1) requires access='index', got "
                f"{access!r}; " + _SERVE_COMBOS)
        access = "index"
    bucketed = admission == "bucketed"
    if bucketed and warm_start:
        raise ValueError(
            "admission='bucketed' with warm_start=True is unsupported: "
            "containment warm inits are exact-shape per new row; " + _SERVE_COMBOS)
    if not isinstance(batch, QueryBatch):
        batch = QueryBatch.make(batch)
    for spec in batch.specs:
        _algo(spec.algorithm)       # fail fast on unknown algorithms
    groups = [
        (key, [r.source for r in rows], np.asarray([r.window for r in rows], np.int32))
        for key, rows in batch.groups().items()
    ]
    if state is not None and (
        state.graph_ref is not g.src
        or state.mesh != mesh
        or bool(state.group_caps) != bucketed
        or (plan is not None and plan.cache_key != state.plan.cache_key)
    ):
        state = None
    tier = _history_tier(tger, batch.union(), state, coldstore, plan, access)
    if tier != "hot":
        if bucketed or warm_start or mesh is not None:
            raise ValueError(
                f"a below-horizon batch (tier={tier!r}) serves through the "
                f"cold tier, which supports only admission=None, "
                f"warm_start=False, mesh=None; " + _SERVE_COMBOS)
        access = "index"
        if state is not None and state.plan.tier != tier:
            state = None    # a tier switch never consumes the carried state
    order = None
    if bucketed and state is not None:
        # sticky group order: resident groups keep the carried schedule's
        # position, new groups append in batch order, so a retirement that
        # changes which spec comes first never permutes the schedule
        rank = {k: i for i, k in enumerate(state.group_keys)}
        order = sorted(range(len(groups)),
                       key=lambda i: (rank.get(groups[i][0], len(rank)), i))
        if order == list(range(len(groups))):
            order = None
        else:
            groups = [groups[i] for i in order]
    with obs.span("serve.advance", stage=True):
        results, new_state = _advance(
            g, tger, groups, state, plan_arg=plan,
            plan_builder=lambda: plan_batch(
                g, tger, batch, access=access, backend=backend,
                shards=None if mesh is None else mesh_shape(mesh),
                bucketed=bucketed, tier=tier, ladder=int(ladder)),
            warm_start=warm_start, mesh=mesh, bucketed=bucketed,
            bucket_headroom=bucket_headroom, coldstore=coldstore, tier=tier)
    if order is not None:
        inv = [0] * len(order)
        for j, i in enumerate(order):
            inv[i] = j
        results = tuple(results[inv[i]] for i in range(len(inv)))
    return results, new_state


def sweep_incremental(
    g: TemporalGraph,
    source,
    windows,
    tger: Optional[TGERIndex] = None,
    *,
    algorithm: str = "earliest_arrival",
    state: Optional[SweepState] = None,
    access: str = "auto",
    backend: str = "xla_segment",
    plan: Optional[AccessPlan] = None,
    warm_start: bool = False,
    coldstore=None,
    ladder: int = 0,
    tiny_budget_gate: bool = False,
    **kwargs,
):
    """Serve ``windows`` reusing the previous sweep's :class:`SweepState`:
    the single-tenant (one algorithm, one source) wrapper over the engine
    ``serve_batch`` drives.

    Returns ``(results, state)``, ``results`` shaped like :func:`sweep`'s.
    A state from another graph / source / algorithm / kwargs / plan, a
    bucketed or a sharded one, is not reused and not consumed (a cold
    start).  Index and
    hybrid plans advance their ring by the entering positions; scan plans
    reuse the full view.  ``warm_start=True``, ``ladder`` and ``coldstore``
    as in :func:`serve_batch` (a below-horizon sweep refuses
    ``warm_start``).  ``tiny_budget_gate=True`` serves a hot-tier index or
    hybrid chain whose ring capacity (or budget) is at most
    :data:`TINY_BUDGET_RING` cold under the pinned plan and returns
    ``None`` as the state (dispatch tags ``gate:tiny-budget``,
    ``cold:gated``); the rows are the fused advance's.  The gate follows
    the reference; on the H100 a gated chain is slower than the fused
    advance (see ``TINY_BUDGET_RING``)."""
    entry = _algo(algorithm)
    windows = to_numpy(windows).astype(np.int32).reshape(-1, 2)
    params = tuple(sorted(kwargs.items()))
    if entry.source_free:
        src = None
    else:
        flat = np.asarray(to_numpy(source)).reshape(-1)
        if flat.size != 1:
            raise ValueError(
                "serving rows take ONE source each (multi-seed source sets "
                "are not supported); submit separate per-source queries — "
                "e.g. a QueryBatch of one-source rows to serve_batch, whose "
                "rows are independent answers, not a joint multi-seed run")
        src = int(flat[0])
    key = (algorithm, params)
    groups = [(key, [src] * len(windows), windows)]
    reusable = (
        state is not None
        and state.group_keys == (key,)
        and state.graph_ref is g.src
        and state.mesh is None            # sharded states belong to serve_batch
        and not state.group_caps          # bucketed states: padded buffers
        and all(s == src for s in state.group_sources[0])
        and (plan is None or plan.cache_key == state.plan.cache_key)
    )
    state = state if reusable else None
    union = (int(windows[:, 0].min()), int(windows[:, 1].max()))
    tier = _history_tier(tger, union, state, coldstore, plan, access)
    if tier != "hot":
        if warm_start:
            raise ValueError(
                f"a below-horizon sweep (tier={tier!r}) serves through the "
                f"cold tier, which refuses warm_start; " + _SERVE_COMBOS)
        access = "index"
        if state is not None and state.plan.tier != tier:
            state = None    # a tier switch never consumes the carried state
    if tiny_budget_gate and tier == "hot":
        p = plan if plan is not None else plan_query(
            g, tger, windows=windows, access=access, backend=backend, tier=tier,
            ladder=int(ladder))
        if p.method in ("index", "hybrid") and (p.ring_capacity or p.budget) \
                <= TINY_BUDGET_RING:
            # at tiny ring capacities the advance's fixed costs dominate:
            # a stateless cold solve under the pinned plan, no SweepState
            # (the gate fires again on every sweep of the chain)
            obs.note("gate:tiny-budget")
            obs.note("cold:gated")
            return entry.batched(g, src, windows, tger, p, kwargs), None
    with obs.span("serve.advance", stage=True):
        results, new_state = _advance(
            g, tger, groups, state, plan_arg=plan,
            plan_builder=lambda: plan_query(g, tger, windows=windows, access=access,
                                            backend=backend, tier=tier,
                                            ladder=int(ladder)),
            warm_start=warm_start, coldstore=coldstore, tier=tier)
    return results[0], new_state


__all__ = [
    "sweep",
    "sweep_looped",
    "sweep_incremental",
    "serve_batch",
    "SweepState",
    "QueryBatch",
    "QuerySpec",
    "query_mesh",
    "sliding_windows",
    "dispatch_log",
    "ALGORITHMS",
]
