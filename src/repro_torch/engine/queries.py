"""QueryBatch: the multi-tenant query unit, host-side and pure Python.

A serving tenant asks ``(algorithm, source, window, params)``; the
multi-tenant engine answers a whole SET of those from one shared temporal
structure: one union AccessPlan, one ring advance, one advance of every
group.  This module is the normal form that planning (``plan_batch``) and
serving (``serve.serve_batch`` / ``sweep_incremental``) agree on:

  * :class:`QuerySpec` — one tenant's request: an algorithm name, zero or
    more source vertices, one window, and the algorithm kwargs.  A spec
    with S sources expands into S rows, each one [V] answer.
  * :class:`QueryBatch` — an ordered tuple of specs.  ``groups()`` buckets
    the expanded rows by ``(algorithm, params)``, the unit one batched
    ``*_over_view`` solve consumes, and ``signature()`` is the batch-SHAPE
    descriptor (group structure and row counts, never sources or window
    bounds) that rides the AccessPlan cache key.

Source-free algorithms (pagerank, cc, kcore) take ``sources=None``.  The
port keeps its own copy of the JAX package's module: signatures, row
order and dedup maps are equal character for character.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Algorithms whose rows carry no source vertex.  Kept here (not in serve)
# so spec normalization needs no import of the serving dispatch table;
# serve validates against its own registry again at dispatch time.
SOURCE_FREE = ("pagerank", "cc", "kcore")

# Default cost class per algorithm (DESIGN.md §7.6): "deep" tenants run
# long fixpoints (pagerank's fixed iteration ladder, betweenness's
# two-pass DAG accumulation) and would stall the fused dispatch every
# cheap tenant shares; the serving daemon splits fused schedules by class
# and round-robins the deep classes across advances.  A QuerySpec may
# override with an explicit ``cost_class=``.
DEEP_ALGORITHMS = ("pagerank", "betweenness")
DEFAULT_COST_CLASS = "cheap"


def cost_class_for(algorithm: str) -> str:
    return "deep" if algorithm in DEEP_ALGORITHMS else DEFAULT_COST_CLASS


def bucket_capacity(n: int, prev_cap: int = 0) -> int:
    """The admission bucket ladder (DESIGN.md §7.6): group row counts pad
    to power-of-two capacities, so a tenant admitted (or retired) inside a
    bucket changes no buffer shape.  ``prev_cap`` applies hysteresis: a
    resident group keeps its capacity while ``prev_cap // 4 < n <=
    prev_cap``."""
    n = max(int(n), 1)
    if prev_cap and prev_cap // 4 < n <= prev_cap:
        return int(prev_cap)
    return 1 << (n - 1).bit_length()


def _params_token(params) -> Tuple[Tuple[str, Any], ...]:
    if isinstance(params, dict):
        items = params.items()
    else:
        items = tuple(params)
    return tuple(sorted((str(k), v) for k, v in items))


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One tenant's request.  ``sources`` is a tuple of seed vertices
    (empty for source-free algorithms); ``params`` the algorithm kwargs as
    a sorted item tuple (hashable: it is part of the group key)."""

    algorithm: str
    window: Tuple[int, int]
    sources: Tuple[int, ...] = ()
    params: Tuple[Tuple[str, Any], ...] = ()
    cost_class: Optional[str] = None    # None = derive from the algorithm
    pinned: bool = False                # window is historical: never re-anchor

    @classmethod
    def make(cls, algorithm: str, window, sources=None, cost_class=None,
             pinned=False, **params) -> "QuerySpec":
        """Normalizing constructor: scalar/sequence sources, any window
        pair, kwargs as params.  ``cost_class`` overrides the per-algorithm
        default (DEEP_ALGORITHMS -> "deep", else "cheap") — it tags the
        spec for the serving daemon's class-split scheduling and is NOT
        part of the group key or the batch signature.  ``pinned=True``
        marks a time-travel tenant: the daemon must serve its window
        VERBATIM (through the cold tier when it precedes the hot horizon)
        and ``tick`` must never re-anchor it to the advancing frontier."""
        if sources is None:
            src: Tuple[int, ...] = ()
        elif np.ndim(sources) == 0:
            src = (int(sources),)
        else:
            src = tuple(int(s) for s in np.asarray(sources).reshape(-1))
        if algorithm in SOURCE_FREE and src:
            raise ValueError(f"{algorithm} is source-free: pass sources=None")
        if algorithm not in SOURCE_FREE and not src:
            raise ValueError(f"{algorithm} needs at least one source")
        return cls(
            algorithm=str(algorithm),
            window=(int(window[0]), int(window[1])),
            sources=src,
            params=_params_token(params),
            cost_class=None if cost_class is None else str(cost_class),
            pinned=bool(pinned),
        )

    @property
    def resolved_cost_class(self) -> str:
        return (self.cost_class if self.cost_class is not None
                else cost_class_for(self.algorithm))

    @property
    def n_rows(self) -> int:
        return max(len(self.sources), 1)


@dataclasses.dataclass(frozen=True)
class QueryRow:
    """One expanded (algorithm, source, window) row: the atomic unit of
    matching/reuse in the incremental server.  ``source`` is None for
    source-free algorithms.  ``spec_index`` points back at the originating
    spec (result navigation)."""

    algorithm: str
    params: Tuple[Tuple[str, Any], ...]
    source: Optional[int]
    window: Tuple[int, int]
    spec_index: int

    @property
    def group_key(self) -> Tuple[str, tuple]:
        return (self.algorithm, self.params)


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """An ordered set of :class:`QuerySpec` — THE unit of multi-tenant
    planning and serving."""

    specs: Tuple[QuerySpec, ...]

    @classmethod
    def make(cls, specs: Sequence[QuerySpec]) -> "QueryBatch":
        specs = tuple(specs)
        if not specs:
            raise ValueError("a QueryBatch needs at least one QuerySpec")
        return cls(specs=specs)

    # -- the row/group normal form ----------------------------------------

    def rows(self) -> List[QueryRow]:
        """Expanded rows, batch order: specs in order, a spec's sources in
        order."""
        out: List[QueryRow] = []
        for i, spec in enumerate(self.specs):
            if spec.sources:
                for s in spec.sources:
                    out.append(QueryRow(spec.algorithm, spec.params, s,
                                        spec.window, i))
            else:
                out.append(QueryRow(spec.algorithm, spec.params, None,
                                    spec.window, i))
        return out

    def groups(self) -> Dict[Tuple[str, tuple], List[QueryRow]]:
        """Rows bucketed by ``(algorithm, params)`` in first-appearance
        order — one bucket = one batched ``*_over_view`` solve.  The order
        is deterministic so a shape-stable batch stream produces a stable
        group schedule."""
        out: Dict[Tuple[str, tuple], List[QueryRow]] = {}
        for row in self.rows():
            out.setdefault(row.group_key, []).append(row)
        return out

    @property
    def n_rows(self) -> int:
        return sum(spec.n_rows for spec in self.specs)

    def union(self) -> Tuple[int, int]:
        return (
            min(s.window[0] for s in self.specs),
            max(s.window[1] for s in self.specs),
        )

    def windows(self) -> List[Tuple[int, int]]:
        """Distinct windows, first-appearance order (what the union planner
        budgets over)."""
        seen: Dict[Tuple[int, int], None] = {}
        for s in self.specs:
            seen.setdefault(s.window, None)
        return list(seen)

    def by_cost_class(self) -> Dict[str, "QueryBatch"]:
        """Specs split into per-cost-class sub-batches, first-appearance
        class order — the unit the serving daemon schedules round-robin
        (DESIGN.md §7.6): each class gets its own advance chain, so a deep
        tenant's 100-iteration loop never sits in the advance a cheap
        tenant's latency waits on."""
        out: Dict[str, List[QuerySpec]] = {}
        for spec in self.specs:
            out.setdefault(spec.resolved_cost_class, []).append(spec)
        return {c: QueryBatch.make(s) for c, s in out.items()}

    def signature(self, bucketed: bool = False) -> str:
        """The static batch-SHAPE descriptor that rides the AccessPlan
        cache key: per-group algorithm names + row counts (readable) plus
        a crc of the full (algorithm, params, n_rows) group structure
        (collision-safe for distinct param sets).  Window bounds and
        source ids are deliberately EXCLUDED, so a shape-stable tenant
        stream keeps one plan.  ``bucketed=True`` keys the
        BUCKETED row capacities instead of the exact counts (the admission
        ladder of DESIGN.md §7.6), so tenant churn inside a bucket reuses
        the same plan."""
        parts = []
        desc = []
        for (alg, params), rows in self.groups().items():
            n = bucket_capacity(len(rows)) if bucketed else len(rows)
            parts.append(f"{alg}x{n}{'b' if bucketed else ''}")
            desc.append((alg, params, n))
        crc = zlib.crc32(repr(desc).encode()) & 0xFFFFFFFF
        return "+".join(parts) + f"#{crc:08x}"


def dedup_rows(sources, windows):
    """Cross-query row dedup within one (algorithm, params) group: rows
    with identical ``(source, window)`` collapse to ONE solved row.

    ``sources`` is a sequence of source ids (None entries for source-free
    rows); ``windows`` an i32[Q, 2] array.  Returns ``(unique_sources,
    unique_windows, inverse)`` — unique rows in first-appearance order and
    a ``tuple`` mapping every original row to its unique row, so the
    engine solves the unique rows and FANS OUT at assembly
    (``solved[inverse]``).  Identical tenants (the common many-users-one-
    dashboard shape) then cost one fixpoint row, not Q — and the sharded
    row partition (``distributed.query_shard.row_partition``) operates on
    the already-deduplicated axis."""
    windows = np.asarray(windows, np.int32).reshape(-1, 2)
    seen: Dict[Tuple[Any, int, int], int] = {}
    u_sources: List[Any] = []
    u_windows: List[Tuple[int, int]] = []
    inverse: List[int] = []
    for s, w in zip(sources, windows):
        key = (s, int(w[0]), int(w[1]))
        j = seen.get(key)
        if j is None:
            j = len(u_sources)
            seen[key] = j
            u_sources.append(s)
            u_windows.append((int(w[0]), int(w[1])))
        inverse.append(j)
    return (u_sources, np.asarray(u_windows, np.int32).reshape(-1, 2),
            tuple(inverse))


__all__ = ["QuerySpec", "QueryRow", "QueryBatch", "SOURCE_FREE",
           "DEEP_ALGORITHMS", "DEFAULT_COST_CLASS", "cost_class_for",
           "bucket_capacity", "dedup_rows"]
