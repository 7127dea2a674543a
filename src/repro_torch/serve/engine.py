"""Serving engines (the port of ``repro/serve/engine.py``).

``ServeEngine`` is LM continuous batching: a fixed array of slots, each
holding one request's KV rows and current length.  Each engine step decodes
every slot in one ``decode_step`` (K4 on the card); finished slots (EOS,
budget or ``max_seq``) are refilled from the queue through ``prefill`` into
the slot's cache rows.  Greedy decoding, ``torch.argmax`` taking the first
index of a tie as ``jnp.argmax`` does.

``GraphBatchServer`` serves temporal-graph tenants over ``serve_batch``: a
batch mode (one advance per tick) and a daemon mode (submit / retire /
tick, cost classes, bucketed admission, pinned history tenants).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import to_numpy
from repro_torch.engine.queries import DEFAULT_COST_CLASS, QueryBatch, QuerySpec
from repro_torch.models.transformer import LM, decode_step, init_cache, prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] token ids
    max_new_tokens: int = 32
    generated: Optional[List[int]] = None


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens_generated: int = 0
    requests_completed: int = 0


class ServeEngine:
    def __init__(self, model: LM, batch_slots: int, max_seq: int, eos_id: int = -1):
        self.model = model
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.cache = init_cache(model.cfg, batch_slots, max_seq, device=model.device)
        self.lengths = np.zeros(batch_slots, np.int32)
        self.last_tokens = np.zeros(batch_slots, np.int32)
        self.budget = np.zeros(batch_slots, np.int32)       # remaining new tokens
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.queue: Deque[Request] = deque()
        self.stats = EngineStats()

    # -- request management ---------------------------------------------------

    def submit(self, req: Request):
        req.generated = []
        self.queue.append(req)

    def _prefill(self, slot: int, prompt: np.ndarray) -> int:
        """Prefill ``prompt`` into slot ``slot``'s cache rows; returns the
        first generated token."""
        tokens = torch.as_tensor(prompt, device=self.model.device)[None, :]
        logits, pcache = prefill(self.model, tokens, max_seq=self.max_seq)
        for key in ("k", "v"):
            self.cache[key][:, slot] = pcache[key][:, 0]
        return int(torch.argmax(logits[0]))

    def _fill_slots(self):
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            while self.queue:
                req = self.queue.popleft()
                if req.max_new_tokens <= 0:
                    # zero-budget request: completes with no tokens — it
                    # never even prefills, and the slot stays free
                    self.stats.requests_completed += 1
                    continue
                tok = self._prefill(s, req.prompt)
                req.generated.append(tok)
                self.stats.tokens_generated += 1  # first token (from prefill)
                if req.max_new_tokens == 1:
                    # the prefill token is the whole budget: finish at fill
                    # time, leaving the slot free for the next request
                    self.stats.requests_completed += 1
                    continue
                self.active[s] = req
                self.lengths[s] = len(req.prompt)
                self.last_tokens[s] = tok
                self.budget[s] = req.max_new_tokens - 1
                break

    # -- engine loop ------------------------------------------------------------

    def _decode(self) -> np.ndarray:
        """One ``decode_step`` over every slot; the next token of each."""
        dev = self.model.device
        tokens = torch.tensor(self.last_tokens, device=dev)
        lengths = torch.tensor(self.lengths, device=dev)
        logits, self.cache = decode_step(self.model, self.cache, tokens, lengths)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def step(self) -> int:
        """One decode step over all active slots; returns #active."""
        self._fill_slots()
        active_mask = np.array([r is not None for r in self.active])
        if not active_mask.any():
            return 0
        next_tokens = self._decode()

        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            tok = int(next_tokens[s])
            req.generated.append(tok)
            self.lengths[s] += 1
            self.last_tokens[s] = tok
            self.budget[s] -= 1
            self.stats.tokens_generated += 1
            done = (
                tok == self.eos_id
                or self.budget[s] <= 0
                or self.lengths[s] >= self.max_seq - 1
            )
            if done:
                self.stats.requests_completed += 1
                self.active[s] = None
                self.lengths[s] = 0
        self.stats.steps += 1
        return int(active_mask.sum())

    def run(self, max_steps: int = 10_000) -> EngineStats:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.stats


# ---------------------------------------------------------------------------
# Temporal-graph batch serving
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphServeStats:
    advances: int = 0
    cold_advances: int = 0
    rows_served: int = 0
    rows_solved: int = 0            # rows actually solved after dedup
    dispatches: int = 0             # all dispatch-site hits (cold + fused)
    fused_dispatches: int = 0       # one per steady-state advance
    ticks: int = 0                  # daemon ticks served
    admissions: int = 0             # tenants admitted by the daemon
    retirements: int = 0            # tenants retired by the daemon


@dataclasses.dataclass(frozen=True)
class TickReport:
    """What one daemon tick did: the churn it applied, the cost classes it
    served, and host-snapshot per-tenant results for the SERVED classes
    (tenants whose deep class was skipped this round keep their previous
    answer: the round-robin contract)."""

    tick: int
    t_now: int
    classes_served: Tuple[str, ...]
    admitted: Tuple[int, ...]
    retired: Tuple[int, ...]
    results: Dict[int, Any]         # tenant id -> [n_rows, V] host rows
                                    # (tuple of arrays for multi-output)
    latency_s: float


def _snapshot(r):
    """Host (numpy) copy of one group's result or result tuple."""
    return tuple(to_numpy(x) for x in r) if isinstance(r, tuple) else to_numpy(r)


class GraphBatchServer:
    """Continuous batch serving for temporal-graph queries.

    Two modes share the server.  The batch mode is one ``advance(batch)``
    call per tick: the whole (algorithm x source x window)
    :class:`~repro_torch.engine.queries.QueryBatch` rides one ring advance.
    The server carries the single-use ``SweepState`` between ticks and
    copies results to the host before handing them out (the next advance
    writes the carried ring in place).  If an advance raises the state is
    INVALIDATED (it may already have been consumed), so the next advance
    runs cold.

    The daemon mode is ``submit`` / ``retire`` / ``tick``: tenants are
    long-lived sliding-window subscriptions, churn queues and is applied
    at tick boundaries, and each tick serves the instantaneous batch split
    by COST CLASS (the cheap class every tick, the deep classes round-robin
    one per tick), each class chain with ``admission="bucketed"``.  The
    daemon tracks a per-class EWMA of admission arrivals and passes a
    STICKY quantization of it as ``bucket_headroom``: it grows the moment
    the forecast does but shrinks only on a 4x forecast collapse (the
    bucket ladder's hysteresis), so a decaying EWMA cannot flap group
    capacities across bucket rungs.

    Tenants submitted with ``pinned=True`` keep their historical window
    VERBATIM (``tick`` never re-anchors it) and serve every tick as the
    ``HISTORY_CLASS`` through the cold tier of the server's ``coldstore``,
    unbucketed; the repeat serve of an unchanged pinned window is the noop
    path.

    ``mesh`` (``D``, ``(E, D)`` or a ``DeviceMesh``) serves every hot chain
    sharded, as ``serve_batch(mesh=...)`` does: every rank of the process
    group runs the same server on the same requests and gets every row.
    The history class stays unsharded.
    """

    #: EWMA smoothing for the per-class admission arrival rate (rows/tick)
    #: and the safety factor headroom applies on top of the forecast.
    EWMA_ALPHA = 0.5
    HEADROOM_SAFETY = 2.0

    #: the scheduling class of pinned (time-travel) tenants: disjoint from
    #: every cost class, served every tick through the cold tier
    HISTORY_CLASS = "history"

    def __init__(self, graph, tger=None, *, access: str = "auto",
                 backend: str = "xla_segment", plan=None, mesh=None,
                 warm_start: bool = False, admission: Optional[str] = None,
                 coldstore=None):
        self.graph = graph
        self.mesh = mesh
        self.tger = tger
        self.access = access
        self.backend = backend
        self.plan = plan
        self.warm_start = warm_start
        self.admission = admission
        self.coldstore = coldstore
        self.state = None
        self.stats = GraphServeStats()
        self.latencies: List[float] = []    # per class-serve seconds
        # -- daemon registries (tick mode) ---------------------------------
        self._tenants: Dict[int, QuerySpec] = {}    # tid -> template spec
        self._pending_admit: Deque[Tuple[int, QuerySpec]] = deque()
        self._pending_retire: Deque[int] = deque()
        self._next_tid = 0
        self._class_states: Dict[str, Any] = {}     # class -> SweepState
        self._rr_last: Optional[str] = None         # deep class NAME last
                                                    # served (round-robin)
        self._admit_ewma: Dict[str, float] = {}     # class -> rows/tick EWMA
        self._admit_hr: Dict[str, int] = {}         # class -> sticky headroom

    def _account(self, batch, state, log) -> None:
        self.stats.advances += 1
        if state.last_advance == "cold":
            self.stats.cold_advances += 1
        self.stats.rows_served += int(batch.n_rows)
        self.stats.rows_solved += int(state.n_solved_unique)
        self.stats.dispatches += len(log)
        self.stats.fused_dispatches += sum(1 for t in log if t.startswith("fused:"))

    # -- batch mode ---------------------------------------------------------

    def advance(self, batch) -> List:
        """Serve one batch tick; returns host-snapshot per-group results
        (grouped as :func:`repro_torch.serve.serve_batch` groups them)."""
        from repro_torch.serve import window_sweep as ws

        with ws.dispatch_log() as log:
            try:
                results, self.state = ws.serve_batch(
                    self.graph, batch, self.tger, state=self.state,
                    access=self.access, backend=self.backend, plan=self.plan,
                    warm_start=self.warm_start, mesh=self.mesh,
                    admission=self.admission, coldstore=self.coldstore)
            except BaseException:
                # the carried state may have been consumed before the raise:
                # drop it, so the retry runs cold
                self.state = None
                raise
        snapped = [_snapshot(r) for r in results]
        self._account(batch, self.state, log)
        return snapped

    # -- daemon mode --------------------------------------------------------

    def submit(self, spec: QuerySpec) -> int:
        """Queue a tenant for admission at the next ``tick``; returns its
        tenant id.  The spec is a template: its window's WIDTH is the
        subscription, the bounds re-anchor to every tick's ``t_now``
        (unless ``pinned``)."""
        tid = self._next_tid
        self._next_tid += 1
        self._pending_admit.append((tid, spec))
        return tid

    def retire(self, tid: int) -> None:
        """Queue a tenant for retirement at the next ``tick`` (unknown or
        already-retired ids are ignored there)."""
        self._pending_retire.append(tid)

    @property
    def tenants(self) -> Dict[int, QuerySpec]:
        """The live tenant registry (admitted, not retired): a copy."""
        return dict(self._tenants)

    def _class_of(self, spec: QuerySpec) -> str:
        """The scheduling class of one spec: pinned tenants are the
        HISTORY_CLASS whatever their algorithm (a cold-tier solve, not a
        chain advance); every other tenant keeps its cost class."""
        return self.HISTORY_CLASS if spec.pinned else spec.resolved_cost_class

    def _next_deep(self, deep: List[str]) -> str:
        """Round-robin over the live deep classes by NAME: the successor of
        the last-served class in sorted order, so a class that empties
        mid-rotation makes no survivor skip or double-serve."""
        order = sorted(deep)
        if self._rr_last in order:
            nxt = order[(order.index(self._rr_last) + 1) % len(order)]
        else:
            # the last-served class emptied (or this is the first deep
            # tick): resume at the first live class after it, wrapping
            nxt = order[0]
            if self._rr_last is not None:
                for c in order:
                    if c > self._rr_last:
                        nxt = c
                        break
        self._rr_last = nxt
        return nxt

    def bucket_headroom(self, cls: str) -> int:
        """The arrival-rate bucket headroom of one cost class: the rows its
        buckets reserve for tenants expected before the next serve.  The
        STICKY value ``tick`` maintains: ``ceil(EWMA rate * safety)``
        upward at once, downward only on a 4x forecast collapse."""
        return self._admit_hr.get(cls, 0)

    def _serve_class(self, cls: str, sub: QueryBatch, tids: List[int],
                     results: Dict[int, Any]) -> None:
        from repro_torch.serve import window_sweep as ws

        t0 = time.perf_counter()
        # the history class serves pinned windows through the cold tier,
        # which refuses bucketed admission and the mesh; every class carries
        # the store so hot index advances compact
        history = cls == self.HISTORY_CLASS
        with ws.dispatch_log() as log:
            try:
                res, st = ws.serve_batch(
                    self.graph, sub, self.tger,
                    state=self._class_states.get(cls),
                    access=self.access, backend=self.backend, plan=self.plan,
                    admission=None if history else "bucketed",
                    mesh=None if history else self.mesh,
                    bucket_headroom=0 if history else self.bucket_headroom(cls),
                    coldstore=self.coldstore)
            except BaseException:
                self._class_states.pop(cls, None)   # may be consumed: go cold
                raise
        self._class_states[cls] = st
        self._account(sub, st, log)
        # host snapshot per tenant of the group's REAL rows (the bucketed
        # buffers are padded to the bucket capacity; the pad rows stay on
        # the device)
        for gi, rows in enumerate(sub.groups().values()):
            r = res[gi]
            host = tuple(to_numpy(x[:len(rows)])
                         for x in (r if isinstance(r, tuple) else (r,)))
            per_spec: Dict[int, List[int]] = {}
            for j, row in enumerate(rows):
                per_spec.setdefault(row.spec_index, []).append(j)
            for si, row_ids in per_spec.items():
                picked = tuple(h[row_ids] for h in host)
                results[tids[si]] = picked[0] if len(picked) == 1 else picked
        self.latencies.append(time.perf_counter() - t0)

    def tick(self, t_now: int) -> TickReport:
        """One daemon tick: apply pending churn, re-anchor every live
        (unpinned) tenant's window to end at ``t_now``, and serve the
        instantaneous batch by cost class (cheap every tick, the deep
        classes round-robin one per tick, the history class every tick).
        Served tenants' results are host snapshots sliced to their rows."""
        t_start = time.perf_counter()
        admitted: List[int] = []
        arrived: Dict[str, int] = {}    # class -> rows admitted NOW
        while self._pending_admit:
            tid, spec = self._pending_admit.popleft()
            self._tenants[tid] = spec
            admitted.append(tid)
            self.stats.admissions += 1
            cls = self._class_of(spec)
            arrived[cls] = arrived.get(cls, 0) + max(1, len(spec.sources))
        retired: List[int] = []
        while self._pending_retire:
            tid = self._pending_retire.popleft()
            if self._tenants.pop(tid, None) is not None:
                retired.append(tid)
                self.stats.retirements += 1
        # a class whose last tenant retired drops its EWMA and headroom: a
        # re-admission after a quiet gap must not inherit the old sticky
        # headroom.  Classes arriving THIS tick keep theirs.
        live_now = {self._class_of(s) for s in self._tenants.values()}
        for cls in list(self._admit_ewma):
            if cls not in live_now and cls not in arrived:
                self._admit_ewma.pop(cls, None)
                self._admit_hr.pop(cls, None)
        for cls in set(self._admit_ewma) | set(arrived):
            prev = self._admit_ewma.get(cls, 0.0)
            self._admit_ewma[cls] = (
                (1.0 - self.EWMA_ALPHA) * prev
                + self.EWMA_ALPHA * arrived.get(cls, 0))
            # sticky headroom: grow on a higher forecast now, shrink only
            # when the forecast collapses 4x
            want = int(np.ceil(self._admit_ewma[cls] * self.HEADROOM_SAFETY))
            held = self._admit_hr.get(cls, 0)
            if want > held or want < held // 4:
                self._admit_hr[cls] = want
        self.stats.ticks += 1
        tick_no = self.stats.ticks
        results: Dict[int, Any] = {}
        classes_served: Tuple[str, ...] = ()
        if self._tenants:
            # the instantaneous batch: every live tenant's window slid to
            # end at t_now (width kept), pinned tenants' windows verbatim
            tids_all: List[int] = []
            specs: List[QuerySpec] = []
            for tid, spec in self._tenants.items():
                if spec.pinned:
                    specs.append(spec)
                else:
                    width = int(spec.window[1]) - int(spec.window[0])
                    specs.append(dataclasses.replace(
                        spec, window=(int(t_now) - width, int(t_now))))
                tids_all.append(tid)
            by_cls: Dict[str, List[int]] = {}
            for i, spec in enumerate(specs):
                by_cls.setdefault(self._class_of(spec), []).append(i)
            serve_now = [c for c in by_cls
                         if c in (DEFAULT_COST_CLASS, self.HISTORY_CLASS)]
            deep = [c for c in by_cls
                    if c not in (DEFAULT_COST_CLASS, self.HISTORY_CLASS)]
            if deep:
                serve_now.append(self._next_deep(deep))
            for cls in serve_now:
                idxs = by_cls[cls]
                self._serve_class(cls, QueryBatch.make([specs[i] for i in idxs]),
                                  [tids_all[i] for i in idxs], results)
            classes_served = tuple(serve_now)
        return TickReport(
            tick=tick_no, t_now=int(t_now), classes_served=classes_served,
            admitted=tuple(admitted), retired=tuple(retired),
            results=results, latency_s=time.perf_counter() - t_start)

    @property
    def devices(self) -> int:
        """Devices (ranks) the batch-mode chain runs on: the size of its
        state's mesh, one when unsharded."""
        return 1 if self.state is None or self.state.mesh is None else (
            int(self.state.mesh.size()))


__all__ = ["Request", "EngineStats", "ServeEngine", "GraphServeStats",
           "TickReport", "GraphBatchServer"]
