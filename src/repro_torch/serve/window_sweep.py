"""Window-query sweeps: one query over W windows.

``sweep`` answers all W windows in one batched execution over the union
window's view; ``sweep_looped`` is its reference, W independent
single-window runs under the same plan.  Both serve the seven algorithms of
the JAX package's sweep; the incremental server (warm starts,
``SweepState``, ``serve_batch``) is not in the port yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

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
)
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex
from repro_torch.device import to_numpy
from repro_torch.engine.plan import AccessPlan, plan_query


class _Algo(NamedTuple):
    batched: Callable   # (g, source, windows, tger, plan, kw) -> [W, V] | tuple
    single: Callable    # (g, source, window, tger, plan, kw) -> [V] | tuple
    n_outputs: int


def _require_k(kw):
    if "k" not in kw:
        raise ValueError("algorithm='kcore' requires the k= parameter")
    kw = dict(kw)
    return kw.pop("k"), kw


def _b_kcore(g, s, w, t, plan, kw):
    k, kw = _require_k(kw)
    return temporal_kcore_batched(g, k, w, t, plan=plan, **kw)


def _s_kcore(g, s, w, t, plan, kw):
    k, kw = _require_k(kw)
    return temporal_kcore(g, k, w, t, plan=plan, **kw)


_ALGOS = {
    "earliest_arrival": _Algo(
        lambda g, s, w, t, plan, kw: earliest_arrival_batched(g, s, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: earliest_arrival(g, s, w, t, plan=plan, **kw),
        1),
    "reachability": _Algo(
        lambda g, s, w, t, plan, kw: overlaps_reachability_batched(
            g, s, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: overlaps_reachability(g, s, w, t, plan=plan, **kw),
        3),
    "pagerank": _Algo(
        lambda g, s, w, t, plan, kw: temporal_pagerank_batched(g, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: temporal_pagerank(g, w, t, plan=plan, **kw),
        1),
    "bfs": _Algo(
        lambda g, s, w, t, plan, kw: temporal_bfs_batched(g, s, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: temporal_bfs(g, s, w, t, plan=plan, **kw),
        2),
    "cc": _Algo(
        lambda g, s, w, t, plan, kw: temporal_cc_batched(g, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: temporal_cc(g, w, t, plan=plan, **kw),
        1),
    "kcore": _Algo(_b_kcore, _s_kcore, 1),
    "betweenness": _Algo(
        lambda g, s, w, t, plan, kw: temporal_betweenness_batched(
            g, s, w, t, plan=plan, **kw),
        lambda g, s, w, t, plan, kw: temporal_betweenness(g, [s], w, t, plan=plan, **kw),
        1),
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


__all__ = ["sliding_windows", "sweep", "sweep_looped", "ALGORITHMS"]
