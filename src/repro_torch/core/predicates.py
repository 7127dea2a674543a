"""Allen-algebra ordering predicates (paper §2.2, §4.1).

A temporal path is valid when every consecutive edge pair (A, B) satisfies
the configured ordering predicate.  In frontier-relaxation form the "A"
side is the per-vertex state (e.g. the arrival time at the edge's source),
so each predicate is a test between a source scalar and the candidate
edge's interval.  The functions work on tensors and numpy arrays alike.

  Succeeds:          end(A) <= start(B)
  StrictlySucceeds:  end(A) <  start(B)
  Overlaps:          start(A) <= start(B) and end(A) <= end(B)
"""
from __future__ import annotations

import enum


class OrderingPredicateType(enum.Enum):
    SUCCEEDS = "succeeds"
    STRICTLY_SUCCEEDS = "strictly_succeeds"
    OVERLAPS = "overlaps"


def edge_follows(
    pred: OrderingPredicateType,
    src_end,
    edge_start,
    edge_end,
    src_start=None,
):
    """May edge B=(edge_start, edge_end) follow a path whose last edge A
    ended at ``src_end`` (and started at ``src_start``)?"""
    if pred is OrderingPredicateType.SUCCEEDS:
        return src_end <= edge_start
    if pred is OrderingPredicateType.STRICTLY_SUCCEEDS:
        return src_end < edge_start
    if pred is OrderingPredicateType.OVERLAPS:
        if src_start is None:
            raise ValueError("OVERLAPS needs the source interval start")
        return (src_start <= edge_start) & (src_end <= edge_end)
    raise ValueError(pred)


def interval_pair_satisfies(pred: OrderingPredicateType, a_start, a_end, b_start, b_end):
    """OrderingPredicate(A, B, T) from Table 2: the explicit two-interval form."""
    return edge_follows(pred, a_end, b_start, b_end, src_start=a_start)


def in_window(t_start, t_end, window_start, window_end):
    """The edge's interval must lie within [window_start, window_end]
    (Alg. 2 lines 2-3: t_s >= t_a and t_e <= t_b)."""
    return (t_start >= window_start) & (t_end <= window_end)


__all__ = [
    "OrderingPredicateType",
    "edge_follows",
    "interval_pair_satisfies",
    "in_window",
]
