"""Frontier-rung ladder: sparse fixpoint rounds proportional to the live
frontier.

A dense fixpoint round relaxes the WHOLE hoisted edge view; the frontier
is only a mask (``valid & frontier[from_v]`` in ``FixpointRunner.step``),
so a deep chain pays O(rounds x E') while the frontier holds a handful of
vertices for most of its tail.  The ladder:

  * a source-grouped **companion view** (:class:`FrontierView`) of the
    hoisted edge view: the view's slot ids sorted by their source vertex
    (a stable ``torch.sort`` on the view's device) and a CSR offset table,
    built once per view and identity-cached;
  * a **sparse round** that pads the frontier to a pow2 vertex rung,
    expands it through the companion offsets into at most ``erung``
    frontier-incident edge slots, and runs the algorithm's relax and
    masked segment combine over ONLY those slots.  Integer min/max/sum
    combines are order-free, so a sparse round equals the dense masked
    round over the same edges bit for bit;
  * a **host segment loop** (:func:`run_laddered`): dense rounds while the
    frontier is wide (they run the algorithm's own combine, so K1 on a
    tiled scan plan), then sparse segments at ``(vrung, erung)`` rungs
    with hysteresis descent.  A frontier that outgrows its rung ends the
    segment BEFORE an uncovered round runs: never a silent truncation.

Each round reads its frontier's occupancy and summed degree to the host
as one two-element tensor: one host sync per round, as the dense runner's
``bool(cond(state))``.

The JAX package keys one jitted program per (rung, plan) and counts its
traces (``ladder_trace_log`` / ``ladder_trace_count``) to prove that a
warmed ladder never retraces.  Eager torch has no trace to count, so
those two are not ported; the ``segments=`` record of
:func:`run_laddered` is the observable that stays.

The ladder engages where the JAX package's does: host-level
``*_over_view`` calls under a plan with ``ladder > 0`` (direct calls and
the serving cold solves).  The JAX package traces its batched entry
points, ``sweep`` and the fused serving advance, so the ladder never runs
there; the port's counterparts call the algorithms' private dense paths.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hostcache import identity_cache
from repro_torch.core.predicates import in_window
from repro_torch.device import to_numpy
from repro_torch.engine.backends import segment_combine
from repro_torch.engine.plan import rung
from repro_torch.engine.queries import bucket_capacity

# the sparse segments' edge rung never drops below this (a handful of tiny
# segments would pay more in host syncs than they save); the descent
# hysteresis is off at the floor, so a frontier with no out-slots still runs
# its (empty) round and converges.
ERUNG_FLOOR = 64
# hand dense -> sparse over when the frontier's summed structural degree
# drops under E' / DENSE_HANDOFF_DIV (a sparse round costs O(V + erung) per
# row against the dense round's O(E'); the pow2 pad still leaves a margin).
DENSE_HANDOFF_DIV = 4


class FrontierView(NamedTuple):
    """Source-grouped companion of one edge view: ``perm`` lists the view's
    slot ids sorted by ``(from_v[slot], slot)``; ``offsets`` is the CSR
    fence (``perm[offsets[v]:offsets[v + 1]]`` are vertex v's slots);
    ``degs`` its diff (structural out-slots per vertex, masked padding
    slots included: they are masked again at gather time, and the count
    only feeds rung selection).  Every slot appears exactly once, so the
    companion never needs rebuilding when only the validity mask moves."""

    perm: torch.Tensor      # i32[E'] slot ids grouped by source vertex
    offsets: torch.Tensor   # i32[V + 1]
    degs: torch.Tensor      # i32[V]


def _from_degs(perm: torch.Tensor, degs: torch.Tensor) -> FrontierView:
    offsets = torch.zeros(degs.shape[0] + 1, dtype=torch.int32, device=degs.device)
    offsets[1:] = torch.cumsum(degs, 0)
    return FrontierView(perm.to(torch.int32), offsets, degs.to(torch.int32))


def build_frontier_view(from_v, n_vertices: int) -> FrontierView:
    """Cold build on the view's device: one stable sort over the view's
    source endpoints (every slot, masked padding included).  The
    permutation equals ``np.argsort(from_v, kind="stable")``."""
    fv = torch.as_tensor(from_v)
    perm = torch.sort(fv, stable=True).indices
    degs = torch.bincount(fv.long(), minlength=int(n_vertices))
    return _from_degs(perm, degs)


def advance_frontier_view(fv: FrontierView, slots, old_from, new_from,
                          n_vertices: int) -> FrontierView:
    """Delta-advance the companion for a ring advance that rewrote
    ``slots`` (distinct slot ids, any order, wrap-around included) from
    source ``old_from[i]`` to ``new_from[i]``: remove the old (vertex, slot)
    entries from the sorted grouping and insert the new ones.  O(E' +
    delta log E') host work, and equal to a cold rebuild over the advanced
    endpoints.  The result lives on ``fv``'s device."""
    slots = np.asarray(to_numpy(slots), np.int64)
    if slots.size == 0:
        return fv
    perm = to_numpy(fv.perm)
    degs = to_numpy(fv.degs).copy()
    C = perm.shape[0]
    old_from = np.asarray(to_numpy(old_from), np.int64)
    new_from = np.asarray(to_numpy(new_from), np.int64)
    # the sorted grouping IS the sorted key array owner * C + slot
    owner = np.repeat(np.arange(n_vertices, dtype=np.int64),
                      np.diff(to_numpy(fv.offsets)))
    keys = owner * C + perm
    keys = np.delete(keys, np.searchsorted(keys, np.sort(old_from * C + slots)))
    ins = np.sort(new_from * C + slots)
    keys = np.insert(keys, np.searchsorted(keys, ins), ins)
    np.subtract.at(degs, old_from, 1)
    np.add.at(degs, new_from, 1)
    dev = fv.perm.device
    return _from_degs(torch.as_tensor(keys % C, device=dev),
                      torch.as_tensor(degs, device=dev))


@identity_cache(16)
def _companion_cached(from_v, n_vertices: int, version: int) -> FrontierView:
    return build_frontier_view(from_v, n_vertices)


def companion_for_view(from_v, n_vertices: int) -> FrontierView:
    """Identity-cached companion: repeated laddered solves over the SAME
    view tensors (a serving cold start solving several groups, a
    benchmark loop) sort once.  A ring advance writes its view in place,
    which bumps the tensor's version counter, so an advanced view never
    reads a stale companion."""
    return _companion_cached(from_v, int(n_vertices), getattr(from_v, "_version", 0))


def ladder_eligible(plan) -> bool:
    """True when a laddered solve may run: the plan opted in (``ladder >
    0``).  The JAX package also refuses traced calls and edge-sharded
    plans; the port has neither, and its dense-only callers take the
    algorithms' private dense paths instead of asking."""
    return plan is not None and plan.ladder > 0


# ---------------------------------------------------------------------------
# the sparse gather: frontier rows -> covered edge-slot rows
# ---------------------------------------------------------------------------

def _first_active(frontier: torch.Tensor, vrung: int) -> torch.Tensor:
    """i64[Q, vrung]: each row's first ``vrung`` frontier vertices in
    ascending order, padded with V (``jnp.nonzero(size=, fill_value=V)``
    row by row), with no host sync: the k-th frontier vertex is the first
    position where the row's running count reaches k + 1, and a row with
    fewer finds none (V)."""
    count = torch.cumsum(frontier, 1)                    # i64[Q, V]
    want = torch.arange(1, vrung + 1, device=frontier.device).repeat(frontier.shape[0], 1)
    return torch.searchsorted(count, want)


def gather_frontier_slots(fv: FrontierView, frontier: torch.Tensor, vrung: int,
                          erung: int, n_vertices: int):
    """[Q, erung] slot ids covering EVERY frontier-incident slot of every
    row, and the bool coverage mask (False = pow2 padding).  Exact coverage
    needs per-row occupancy <= vrung and summed degree <= erung; the
    segment loop checks both before a round runs."""
    av = _first_active(frontier, vrung)
    # a padding entry (V) reads the empty range [offsets[V], offsets[V])
    lo = fv.offsets[av].long()
    deg = fv.offsets[(av + 1).clamp(max=n_vertices)].long() - lo
    csum = torch.cumsum(deg, 1)
    pos = torch.arange(erung, device=frontier.device).repeat(frontier.shape[0], 1)
    own = torch.searchsorted(csum, pos, right=True).clamp(max=vrung - 1)
    within = pos - (csum.gather(1, own) - deg.gather(1, own))
    slot_idx = (lo.gather(1, own) + within).clamp(0, fv.perm.shape[0] - 1)
    return fv.perm[slot_idx], pos < csum[:, -1:]


def sparse_window_valid(edges, windows: torch.Tensor, slots: torch.Tensor,
                        cov: torch.Tensor):
    """Per-row validity of gathered slots: coverage, the structural mask and
    window membership, the predicate the dense rounds precompute as
    ``runner.valid``, evaluated at the slots only.  Returns ``(valid,
    t_start, t_end)`` at the slots."""
    ts = edges.t_start[slots]
    te = edges.t_end[slots]
    ok = cov & edges.mask[slots] & in_window(ts, te, windows[:, 0:1], windows[:, 1:2])
    return ok, ts, te


def rowwise_combine(vals: torch.Tensor, seg_ids: torch.Tensor, n_segments: int,
                    op: str, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise masked segment combine, [Q, K] -> [Q, n_segments]: the
    sparse round's counterpart of ``combine_windows_for_plan`` (integer
    min/max/sum are order-free, so it equals the dense backends bit for bit
    on the same multiset).  One scatter over the flattened rows."""
    Q, K = vals.shape
    rows = torch.arange(Q, device=vals.device)[:, None] * n_segments
    ids = (seg_ids.long() + rows).reshape(-1)
    out = segment_combine(vals.reshape(-1), ids, Q * n_segments, op,
                          mask=mask.reshape(-1))
    return out.reshape(Q, n_segments)


def take_rows(state: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[Q, V] state gathered at per-row indices [Q, K] -> [Q, K]."""
    return torch.gather(state, 1, idx.long())


# ---------------------------------------------------------------------------
# ladder segments
# ---------------------------------------------------------------------------

class LadderSpec(NamedTuple):
    """One algorithm's ladder contract.

    ``dense_round(runner, state, rnd) -> state`` is the algorithm's own
    dense batched round over the ``FixpointRunner``'s hoisted view and
    prepared segment ids, building anything else it needs once per runner
    through ``runner.hoisted`` (the bit-identity anchor; on a tiled scan
    plan its min-combines run K1).  ``sparse_round(runner, gathered, state, rnd)
    -> state`` consumes one ``(slots, cov)`` gather per companion.
    ``frontier(state) -> bool[Q, V]`` is the live set that rung selection
    and convergence read.  ``rnd`` is the global round count."""

    name: str
    dense_round: Callable
    sparse_round: Callable
    frontier: Callable


def _measures(spec: LadderSpec, state, deg: torch.Tensor) -> Tuple[int, int]:
    """(occupancy, summed degree) of the fullest row, read in ONE sync."""
    f = spec.frontier(state)
    occ = f.sum(1).max()
    sumdeg = torch.where(f, deg, 0).sum(1).max()
    occ, sumdeg = torch.stack([occ, sumdeg]).tolist()
    return occ, sumdeg


def choose_rungs(occ: int, sumdeg: int, prev_vrung: int, prev_erung: int,
                 *, cap: int, n_slots: int, n_vertices: int) -> Tuple[int, int]:
    """Rungs of the next sparse segment: pow2 pads with ``bucket_capacity``
    hysteresis (a frontier inside the previous rung's (cap/4, cap] band
    keeps the rung).  Monotone in (occ, sumdeg): shrinking inputs never
    pick a bigger rung."""
    vrung = min(bucket_capacity(max(occ, 1), prev_vrung), rung(min(cap, n_vertices)))
    floor = min(ERUNG_FLOOR, rung(n_slots))
    erung = max(min(bucket_capacity(max(sumdeg, 1), prev_erung), rung(n_slots)), floor)
    return vrung, erung


def run_laddered(
    spec: LadderSpec,
    runner,
    state,
    *,
    companions: Tuple[FrontierView, ...],
    segments: Optional[list] = None,
):
    """The host segment loop: dense rounds until the frontier's summed
    degree drops under the handoff cutoff, then sparse segments at
    ``(vrung, erung)`` rungs with hysteresis descent; a frontier that
    outgrows its rung ends the segment and the loop re-enters dense or at a
    bigger rung.  ``runner`` is the batched ``FixpointRunner`` over the
    view (its ``max_rounds`` caps the global round count).

    Returns ``(final_state, rounds)``: ``rounds`` is the global executed
    round count, equal to the dense ``run(with_rounds=True)`` count.
    ``segments``, if a list, collects ``(kind, vrung, erung, round_count)``
    per executed segment."""
    E = int(runner.edges.src.shape[0])
    V = runner.n_vertices
    max_rounds = runner.max_rounds
    cap = int(runner.plan.ladder)
    cutoff = max(E // DENSE_HANDOFF_DIV, 1)
    deg = companions[0].degs
    for c in companions[1:]:
        deg = deg + c.degs
    floor = min(ERUNG_FLOOR, rung(E))

    rnd = 0
    occ, sumdeg = _measures(spec, state, deg)
    while True:
        start = rnd
        while rnd < max_rounds and occ > 0 and not (sumdeg <= cutoff and occ <= cap):
            state = spec.dense_round(runner, state, rnd)
            rnd += 1
            occ, sumdeg = _measures(spec, state, deg)
        if segments is not None and rnd > start:
            segments.append(("dense", 0, 0, rnd - start))
        if occ == 0 or rnd >= max_rounds:
            break
        vrung = erung = 0
        while 0 < occ <= cap and sumdeg <= cutoff and rnd < max_rounds:
            vrung, erung = choose_rungs(occ, sumdeg, vrung, erung, cap=cap,
                                        n_slots=E, n_vertices=V)
            at_floor = erung <= floor
            start = rnd
            # descent hysteresis (bucket_capacity's prev // 4 band): a
            # frontier that shrank past a quarter of the rung leaves, so the
            # host re-enters at a smaller rung
            while (rnd < max_rounds and 0 < occ <= vrung and sumdeg <= erung
                   and (at_floor or sumdeg > erung // 4)):
                f = spec.frontier(state)
                gathered = tuple(gather_frontier_slots(c, f, vrung, erung, V)
                                 for c in companions)
                state = spec.sparse_round(runner, gathered, state, rnd)
                rnd += 1
                occ, sumdeg = _measures(spec, state, deg)
            if segments is not None:
                segments.append(("sparse", vrung, erung, rnd - start))
        if occ == 0 or rnd >= max_rounds:
            break
    return state, rnd


__all__ = [
    "FrontierView",
    "build_frontier_view",
    "advance_frontier_view",
    "companion_for_view",
    "ladder_eligible",
    "gather_frontier_slots",
    "sparse_window_valid",
    "rowwise_combine",
    "take_rows",
    "LadderSpec",
    "choose_rungs",
    "run_laddered",
    "ERUNG_FLOOR",
    "DENSE_HANDOFF_DIV",
]
