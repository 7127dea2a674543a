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
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.algorithms import (
    earliest_arrival,
    earliest_arrival_batched,
    earliest_arrival_over_view,
    overlaps_reachability,
    overlaps_reachability_batched,
    overlaps_reachability_over_view,
    temporal_betweenness,
    temporal_betweenness_batched,
    temporal_betweenness_over_view,
    temporal_bfs,
    temporal_bfs_batched,
    temporal_bfs_over_view,
    temporal_cc,
    temporal_cc_batched,
    temporal_cc_over_view,
    temporal_kcore,
    temporal_kcore_batched,
    temporal_kcore_over_view,
    temporal_pagerank,
    temporal_pagerank_batched,
    temporal_pagerank_over_view,
)
from repro_torch.core.edgemap import (
    INT_INF,
    EdgeView,
    advance_hybrid_ring_fields,
    advance_index_ring_fields,
    ring_view_for_plan,
)
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import (
    TGERIndex,
    heavy_window_positions_host,
    window_positions_host,
)
from repro_torch.device import to_numpy
from repro_torch.engine.plan import (
    AccessPlan,
    per_vertex_window_budget,
    plan_batch,
    plan_query,
)
from repro_torch.engine.queries import QueryBatch, QuerySpec, dedup_rows

# ---------------------------------------------------------------------------
# the algorithm dispatch table
# ---------------------------------------------------------------------------

class _Algo(NamedTuple):
    """One algorithm's serving contract.

    ``solve(edges, windows, sources, plan, n_vertices, init, kwargs)`` runs
    a group's rows over a prebuilt (ring) view and returns ``(result,
    rounds)``: the runner's round count for EA, -1 otherwise.  ``warm``
    builds a containment warm init for new rows (None: warm starts
    refused).  ``n_outputs`` is the result-tuple arity (1 = one [Q, V])."""

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


def _solve_ea(edges, windows, sources, plan, n_vertices, init, kwargs):
    return earliest_arrival_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=n_vertices,
        init=init, with_rounds=True, **kwargs)


def _solve_reach(edges, windows, sources, plan, n_vertices, init, kwargs):
    return overlaps_reachability_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=n_vertices,
        init=init, **kwargs), -1


def _solve_pagerank(edges, windows, sources, plan, n_vertices, init, kwargs):
    return temporal_pagerank_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, init=init, **kwargs), -1


def _solve_bfs(edges, windows, sources, plan, n_vertices, init, kwargs):
    return temporal_bfs_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=n_vertices,
        init=init, **kwargs), -1


def _solve_cc(edges, windows, sources, plan, n_vertices, init, kwargs):
    return temporal_cc_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, init=init, **kwargs), -1


def _solve_kcore(edges, windows, sources, plan, n_vertices, init, kwargs):
    k, kwargs = _require_k(kwargs)
    return temporal_kcore_over_view(
        edges, windows, plan=plan, n_vertices=n_vertices, k=k, init=init,
        **kwargs), -1


def _solve_betweenness(edges, windows, sources, plan, n_vertices, init, kwargs):
    return temporal_betweenness_over_view(
        edges, windows, sources=sources, plan=plan, n_vertices=n_vertices,
        init=init, **kwargs), -1


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
# that ``dispatch_log`` opened; a steady-state advance notes exactly one
# "fused:<method>", however many tenants the batch carries.
_DISPATCH_LOG_VAR: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "repro_torch_serve_dispatch_logs", default=())


@contextlib.contextmanager
def dispatch_log():
    """Collect the dispatch-site tags of the enclosed calls: ``with
    dispatch_log() as log: ...``.  Re-entrant: nested scopes stack and every
    enclosing log receives the tags of its whole extent."""
    log: list = []
    token = _DISPATCH_LOG_VAR.set(_DISPATCH_LOG_VAR.get() + (log,))
    try:
        yield log
    finally:
        _DISPATCH_LOG_VAR.reset(token)


def _note(tag: str) -> None:
    for log in _DISPATCH_LOG_VAR.get():
        log.append(tag)


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
    n_solved_unique: int = 0     # rows that ran a fixpoint after dedup
    consumed: bool = False       # a later advance took this state's buffers

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


def _solve_groups(edges, plan, n_vertices, schedule, prev_results,
                  new_windows, new_sources, inits):
    """Every group's solve (of only its genuinely new rows) and row
    assembly over the just-advanced view.  ``schedule`` holds (algorithm,
    params, row_map, new_pos, solve_map) per group; ``solve_map`` (None =
    identity) fans the deduplicated solved rows out onto the new rows."""
    out, rounds_out = [], []
    for gi, (algorithm, params, row_map, new_pos, solve_map) in enumerate(schedule):
        entry = _ALGOS[algorithm]
        prev = prev_results[gi]
        if new_pos:
            sub, rounds = entry.solve(
                edges, new_windows[gi], new_sources[gi], plan, n_vertices,
                inits[gi], dict(params))
            if solve_map is not None:
                sub = _gather_solved(sub, solve_map, entry.n_outputs)
            res = sub if prev is None else _assemble(
                prev, sub, row_map, new_pos, entry.n_outputs)
        else:
            res = _gather_rows(prev, row_map, entry.n_outputs)
            rounds = -1
        out.append(res)
        rounds_out.append(rounds)
    return tuple(out), tuple(rounds_out)


_ADVANCE_RING = {
    "index": advance_index_ring_fields,
    "hybrid": advance_hybrid_ring_fields,
}


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
):
    """The incremental advance shared by ``serve_batch`` and
    ``sweep_incremental``: match every group's rows against the carried
    state, then answer everything in one advance (ring delta + per-group
    solves + row assembly), falling back to a cold plan + build + solve only
    when coverage forces it."""
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

    def freeze(plan, edges, lo, hi, capacity, results, advance, n_solved,
               warm_applied, rounds, n_unique=0):
        return SweepState(
            group_keys=tuple(k for k, _, _ in groups),
            group_sources=tuple(tuple(s) for _, s, _ in groups),
            group_windows=tuple(w.copy() for _, _, w in groups),
            plan=plan, edges=edges, union=union, lo=lo, hi=hi,
            capacity=capacity, results=results, graph_ref=g.src,
            last_advance=advance, n_solved=n_solved, warm_applied=warm_applied,
            last_rounds=rounds[0] if len(rounds) == 1 else tuple(rounds),
            n_solved_unique=n_unique,
        )

    def cold(prev_plan=None):
        p = plan_arg
        if p is None and prev_plan is not None and _plan_covers(
                g, tger, prev_plan, union):
            p = prev_plan
        if p is None:
            p = plan_builder()
        _note("cold:view")
        edges, lo, hi, capacity = ring_view_for_plan(g, tger, union, p)
        results, rounds, n_unique = [], [], 0
        for key, sources, wins in groups:
            entry = _ALGOS[key[0]]
            _note("cold:solve")
            u_sources, u_windows, inverse = dedup_rows(sources, wins)
            n_unique += len(u_sources)
            src_dev = None if entry.source_free else _sources_tensor(u_sources, dev)
            res, rnd = entry.solve(edges, u_windows, src_dev, p, g.n_vertices,
                                   None, dict(key[1]))
            if tuple(inverse) != tuple(range(len(u_sources))):
                res = _gather_solved(res, inverse, entry.n_outputs)
            results.append(res)
            rounds.append(rnd)
        return tuple(results), freeze(
            p, edges, lo, hi, capacity, tuple(results), "cold", n_rows_total,
            False, rounds, n_unique=n_unique)

    if state is None:
        return cold()
    p = state.plan

    # ---- match rows against the previous advance's answered groups --------
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
                n_solved_unique=0)
        _note("reorder")
        results = tuple(
            _gather_rows(state.results[prev_idx[key]], tuple(ms),
                         _ALGOS[key[0]].n_outputs)
            for (key, _, _), ms in zip(groups, matched))
        return results, freeze(
            p, state.edges, state.lo, state.hi, state.capacity, results,
            "reorder", 0, False, [-1] * len(groups))

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
            _note("warm-init")
        return (tuple(schedule), tuple(prev_results), tuple(new_windows),
                tuple(new_sources), tuple(inits), any_warm, n_unique)

    if p.method == "scan":
        (schedule, prev_results, new_windows, new_sources, inits, any_warm,
         n_unique) = build_schedule()
        _note("fused:scan")
        state.consumed = True
        # the scan "ring" is the graph's own arrays: solved over, never written
        results, rounds = _solve_groups(state.edges, p, g.n_vertices, schedule,
                                        prev_results, new_windows, new_sources,
                                        inits)
        return results, freeze(
            p, state.edges, -1, -1, 0, results, "reuse", total_new, any_warm,
            rounds, n_unique=n_unique)

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
        fields = (g.src, g.dst, g.t_start, g.t_end, g.weight)
        perm = (tger.perm_by_start if p.method == "index"
                else tger.heavy_perm_by_start)
        (schedule, prev_results, new_windows, new_sources, inits, any_warm,
         n_unique) = build_schedule()
        _note(f"fused:{p.method}")
        state.consumed = True
        # the entering positions are written into the carried ring in place
        edges = _ADVANCE_RING[p.method](fields, perm, state.edges, state.lo,
                                        lo_new, hi_new, capacity=C)
        results, rounds = _solve_groups(edges, p, g.n_vertices, schedule,
                                        prev_results, new_windows, new_sources,
                                        inits)
        return results, freeze(
            p, edges, lo_new, hi_new, C, results, "delta", total_new, any_warm,
            rounds, n_unique=n_unique)

    return cold()


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _not_ported(mesh, admission, bucket_headroom, coldstore, ladder) -> None:
    """Options of the JAX package's server that the port does not have yet;
    raised before any state is touched."""
    if admission not in (None, "bucketed"):
        raise ValueError(f"unknown admission mode {admission!r}; supported: "
                         f"None (and 'bucketed', not in the port yet)")
    if mesh is not None:
        raise NotImplementedError(
            "serve_batch(mesh=...) (sharded serving) is ROADMAP.md Queue 1 item 14")
    if admission == "bucketed" or bucket_headroom:
        raise NotImplementedError(
            "admission='bucketed' and bucket_headroom (bucketed admission) are "
            "ROADMAP.md Queue 1 item 13")
    if coldstore is not None:
        raise NotImplementedError(
            "coldstore= (tiered history) is ROADMAP.md Queue 1 item 12")
    if ladder:
        raise NotImplementedError(
            "ladder > 0 (the frontier ladder) is ROADMAP.md Queue 1 item 11")


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

    A state from another graph, or with an incompatible explicit ``plan``,
    falls back to a cold serve and is not consumed.  ``warm_start=True``
    opts into the containment warm starts (EA and cc exact, reachability
    sound, refused elsewhere).  ``mesh``, ``admission='bucketed'``,
    ``bucket_headroom``, ``coldstore`` and ``ladder`` are not in the port
    yet and raise ``NotImplementedError`` before any state is consumed."""
    _not_ported(mesh, admission, bucket_headroom, coldstore, ladder)
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
        or (plan is not None and plan.cache_key != state.plan.cache_key)
    ):
        state = None
    return _advance(
        g, tger, groups, state, plan_arg=plan,
        plan_builder=lambda: plan_batch(g, tger, batch, access=access,
                                        backend=backend),
        warm_start=warm_start)


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
    A state from another graph / source / algorithm / kwargs / plan is not
    reused and not consumed (a cold start).  Index and hybrid plans advance
    their ring by the entering positions; scan plans reuse the full view.
    ``warm_start=True`` as in :func:`serve_batch`.  ``coldstore``,
    ``ladder`` and ``tiny_budget_gate`` are not in the port yet and raise
    ``NotImplementedError`` before any state is consumed."""
    _not_ported(None, None, 0, coldstore, ladder)
    if tiny_budget_gate:
        raise NotImplementedError(
            "tiny_budget_gate (serving tiny rings cold) waits for a crossover "
            "measured on the card: ROADMAP.md Queue 4, 'Next'")
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
        and all(s == src for s in state.group_sources[0])
        and (plan is None or plan.cache_key == state.plan.cache_key)
    )
    state = state if reusable else None
    results, new_state = _advance(
        g, tger, groups, state, plan_arg=plan,
        plan_builder=lambda: plan_query(g, tger, windows=windows, access=access,
                                        backend=backend),
        warm_start=warm_start)
    return results[0], new_state


__all__ = [
    "sweep",
    "sweep_looped",
    "sweep_incremental",
    "serve_batch",
    "SweepState",
    "QueryBatch",
    "QuerySpec",
    "sliding_windows",
    "dispatch_log",
    "ALGORITHMS",
]
