"""FixpointRunner — gather-once fixpoint execution.

Every fixpoint algorithm here is "relax over the window-valid edge set
until the frontier empties".  The edge view, the window-validity mask, the
endpoints and the prepared segment ids are loop-invariant, so the runner
builds them once per query and each round pays only the frontier gather,
the relax and the combine.

The loop is a host loop with one ``bool(cond(state))`` sync per round.
Single-window mode holds [V] state; batched mode holds [Q, V] state whose
row q solves ``(sources[q], windows[q])`` over one union-window view.

Under a plan with ``edge_axis`` (an edge-sharded solve) every combine ends
in a collective, so the state ``cond`` reads after a round is the same on
every rank of the edge group: the ranks run the same rounds and make the
same collective calls in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.predicates import in_window
from repro_torch.engine.backends import (
    combine_for_plan,
    combine_windows_for_plan,
    segment_combine,
    segment_combine_windows,
    segments_for,
)
from repro_torch.engine.plan import AccessPlan


class FixpointMetrics(NamedTuple):
    """Convergence record of one fixpoint run.  ``rounds`` counts loop-body
    executions (the last one changes nothing); ``touched_total`` sums, over
    all rounds, the vertices that received at least one valid
    contribution.  ``frontier_trace`` (opt-in) is the i32[max_rounds]
    per-round occupancy on the host: entry r is round r's touched-vertex
    count (summed over batch rows), -1 past the executed rounds; the
    collapse of a deep solve's tail is what the frontier ladder's handoff
    reads."""

    rounds: int
    touched_total: int
    frontier_trace: Optional[torch.Tensor] = None


def _read_cond(cond: Callable, state) -> bool:
    """``bool(cond(state))``: the loop's host read of the device."""
    obs.count("host_reads")
    return bool(cond(state))


class FixpointRunner:
    """Owns one query's view and every loop-invariant quantity."""

    def __init__(
        self,
        edges,                          # EdgeView (prebuilt)
        window=None,                    # (ta, tb) — single-window mode
        *,
        windows=None,                   # [Q, 2] — batched mode
        sources=None,                   # int | [Q] — batched row sources
        plan: AccessPlan,
        n_vertices: int,
        direction: str = "out",
        check_window: bool = True,
        max_rounds: int = 0,
    ):
        if (window is None) == (windows is None):
            raise ValueError("pass exactly one of window= or windows=")
        self.edges = edges
        self.plan = plan
        self.n_vertices = int(n_vertices)
        self.batched = windows is not None
        self.max_rounds = int(max_rounds) or self.n_vertices + 1
        self.device = edges.src.device
        # core.edgemap imports the engine's backends: import it at call time,
        # as the reference does, so ``repro_torch.engine`` can export the runner
        from repro_torch.core.edgemap import _endpoints

        from_v, to_v = _endpoints(edges, direction)
        self.from_v = from_v.long()
        # the tiled kernels need the graph's native dst order
        self.use_layout = plan.method == "scan" and direction == "out"
        self.segments = segments_for(plan, to_v, use_layout=self.use_layout)
        self._hoisted = {}

        if self.batched:
            self.windows = torch.as_tensor(
                windows, dtype=torch.int32, device=self.device).reshape(-1, 2)
            self.window = None
            Q = self.windows.shape[0]
            self.sources = (None if sources is None else torch.as_tensor(
                sources, device=self.device).long().reshape(-1).expand(Q))
            if check_window:
                self.valid = edges.mask[None, :] & in_window(
                    edges.t_start[None, :], edges.t_end[None, :],
                    self.windows[:, 0:1], self.windows[:, 1:2])  # [Q, E']
            else:
                self.valid = edges.mask[None, :].expand(Q, -1).contiguous()
        else:
            self.window = (int(window[0]), int(window[1]))
            self.windows = None
            self.sources = None
            self.valid = (edges.mask & in_window(
                edges.t_start, edges.t_end, *self.window)
                if check_window else edges.mask)                 # [E']

    def hoisted(self, key, build: Callable[[], Any]):
        """``build()`` once per runner, cached under ``key``: the
        loop-invariant tensors and round closures an algorithm derives from
        the view, so a ladder's dense rounds (one call per round) reuse
        them as the dense ``run`` body does."""
        if key not in self._hoisted:
            self._hoisted[key] = build()
        return self._hoisted[key]

    # -- construction ------------------------------------------------------

    @classmethod
    def for_query(cls, g, tger, window, *, plan: Optional[AccessPlan] = None,
                  direction: str = "out", check_window: bool = True,
                  max_rounds: int = 0) -> "FixpointRunner":
        """Single-window runner: one plan-directed view build per query."""
        from repro_torch.core.edgemap import ensure_plan, view_for_plan

        plan = ensure_plan(plan)
        edges = view_for_plan(g, tger, window, plan)
        return cls(edges, window, plan=plan, n_vertices=g.n_vertices,
                   direction=direction, check_window=check_window,
                   max_rounds=max_rounds)

    @classmethod
    def for_windows(cls, g, tger, windows, *, sources=None,
                    plan: Optional[AccessPlan] = None, direction: str = "out",
                    check_window: bool = True,
                    max_rounds: int = 0) -> "FixpointRunner":
        """Batched runner: one union-window view serves all Q rows."""
        from repro_torch.core.edgemap import ensure_plan, union_window, view_for_plan

        plan = ensure_plan(plan)
        edges = view_for_plan(g, tger, union_window(windows), plan)
        return cls(edges, windows=windows, sources=sources, plan=plan,
                   n_vertices=g.n_vertices, direction=direction,
                   check_window=check_window, max_rounds=max_rounds)

    @classmethod
    def for_view(cls, edges, window=None, *, windows=None, sources=None,
                 plan: AccessPlan, n_vertices: int, direction: str = "out",
                 check_window: bool = True,
                 max_rounds: int = 0) -> "FixpointRunner":
        """Wrap an externally built view."""
        return cls(edges, window, windows=windows, sources=sources, plan=plan,
                   n_vertices=n_vertices, direction=direction,
                   check_window=check_window, max_rounds=max_rounds)

    # -- per-row source seeding --------------------------------------------

    def seeded(self, fill, value, dtype=torch.int32) -> torch.Tensor:
        """[Q, V] init: ``fill`` everywhere except ``(q, sources[q])``,
        which holds ``value`` (scalar or [Q])."""
        if not self.batched or self.sources is None:
            raise ValueError("seeded() needs batched mode with sources=")
        Q = self.windows.shape[0]
        rows = torch.arange(Q, device=self.device)
        base = torch.full((Q, self.n_vertices), fill, dtype=dtype, device=self.device)
        base[rows, self.sources] = torch.as_tensor(value, dtype=dtype, device=self.device)
        return base

    def source_frontier(self) -> torch.Tensor:
        """bool[Q, V]: row q's frontier seeded at its own source vertex."""
        if not self.batched or self.sources is None:
            raise ValueError("source_frontier() needs batched mode with sources=")
        Q = self.windows.shape[0]
        f = torch.zeros((Q, self.n_vertices), dtype=torch.bool, device=self.device)
        f[torch.arange(Q, device=self.device), self.sources] = True
        return f

    # -- one relaxation round over the hoisted view ------------------------

    def step(
        self,
        frontier: Optional[torch.Tensor],   # bool[V] | bool[Q, V] | None
        src_state,                          # [V] | [Q, V], or a tuple of them
        relax: Callable,
        combine: str,
        *,
        compute_touched: bool = False,
    ) -> Tuple[Any, Optional[torch.Tensor]]:
        """One relaxation round.  ``src_state`` (a tensor or a tuple of
        tensors) is gathered at each edge's source and handed to
        ``relax(edges, gathered) -> (cand, extra)``; ``extra`` is a bool
        mask ANDed into the edge validity, or None for none.  ``frontier``
        None means every vertex is in the frontier (no frontier gather).
        ``touched`` (segments that received a valid contribution) costs an
        extra segment-sum and is opt-in."""
        cols = (slice(None), self.from_v) if self.batched else self.from_v
        valid = self.valid if frontier is None else self.valid & frontier[cols]
        if isinstance(src_state, tuple):
            gathered = tuple(a[cols] for a in src_state)
        else:
            gathered = src_state[cols]
        cand, extra = relax(self.edges, gathered)
        if extra is not None:
            valid = valid & extra
        if self.batched:
            cand = torch.broadcast_to(cand, valid.shape)
            out = combine_windows_for_plan(
                self.plan, cand, self.segments, self.n_vertices, combine,
                masks=valid)
            touch = segment_combine_windows
        else:
            out = combine_for_plan(self.plan, cand, self.segments,
                                   self.n_vertices, combine, mask=valid)
            touch = segment_combine
        if not compute_touched:
            return out, None
        touched = touch(valid.to(torch.int32), self.segments.ids,
                        self.n_vertices, "sum", axis=self.plan.edge_axis) > 0
        return out, touched

    # -- the loop ----------------------------------------------------------

    def run(self, cond: Callable, body: Callable, init, *,
            with_rounds: bool = False):
        """``while round < max_rounds and cond(state): state = body(state,
        round)``; one host sync per round reads ``cond``."""
        rnd, state = 0, init
        while rnd < self.max_rounds and _read_cond(cond, state):
            state = body(state, rnd)
            rnd += 1
            obs.count("fixpoint.rounds")
        return (state, rnd) if with_rounds else state

    def run_with_metrics(self, cond: Callable, body: Callable, init, *,
                         frontier_trace: bool = False) -> Tuple[Any, FixpointMetrics]:
        """Metered loop: ``body(state, rnd) -> (state, touched)``; returns
        ``(final_state, FixpointMetrics)``.  The touched count, and with
        ``frontier_trace=True`` each round's occupancy, accumulate on the
        device and are read once at the end."""
        rnd, state = 0, init
        touched_total = torch.zeros((), dtype=torch.int64, device=self.device)
        trace = (torch.full((self.max_rounds,), -1, dtype=torch.int32, device=self.device)
                 if frontier_trace else None)
        while rnd < self.max_rounds and _read_cond(cond, state):
            state, touched = body(state, rnd)
            occ = touched.sum()
            touched_total += occ
            if trace is not None:
                trace[rnd] = occ
            rnd += 1
            obs.count("fixpoint.rounds")
        obs.count("host_reads", 1 if trace is None else 2)
        return state, FixpointMetrics(
            rounds=rnd, touched_total=int(touched_total),
            frontier_trace=None if trace is None else trace.cpu())


__all__ = ["FixpointRunner", "FixpointMetrics"]
