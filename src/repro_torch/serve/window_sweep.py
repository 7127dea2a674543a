"""Window-query sweeps: one query over W windows.

``sweep`` answers all W windows in one batched execution over the union
window's view; ``sweep_looped`` is its reference, W independent
single-window runs under the same plan.  The port serves
``earliest_arrival``; the other algorithms come with their modules.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.algorithms.paths import earliest_arrival, earliest_arrival_batched
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex
from repro_torch.device import to_numpy
from repro_torch.engine.plan import AccessPlan, plan_query

ALGORITHMS = ("earliest_arrival",)


def _check_algorithm(algorithm: str) -> None:
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"algorithm must be one of {ALGORITHMS} in the port, got {algorithm!r}")


def sliding_windows(t_end: int, width: int, stride: int, count: int) -> np.ndarray:
    """``count`` windows of ``width`` ending at ``t_end``, sliding back by
    ``stride`` — windows[0] is the most recent.  Returns i32[count, 2]."""
    if count <= 0 or width <= 0 or stride <= 0:
        raise ValueError("count, width and stride must be positive")
    ends = t_end - stride * np.arange(count, dtype=np.int64)
    wins = np.stack([ends - width, ends], axis=1)
    return wins.astype(np.int32)


def _plan(g, tger, windows, plan, access, backend):
    if plan is None:
        plan = plan_query(g, tger, windows=windows, access=access, backend=backend)
    return plan


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
) -> torch.Tensor:
    """Answer one query over W windows in a single batched execution;
    returns [W, V].  ``plan`` defaults to the union-window plan whose
    budgets cover every member window."""
    _check_algorithm(algorithm)
    windows = to_numpy(windows).astype(np.int32).reshape(-1, 2)
    plan = _plan(g, tger, windows, plan, access, backend)
    return earliest_arrival_batched(g, source, windows, tger, plan=plan, **kwargs)


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
) -> torch.Tensor:
    """Reference execution: W independent single-window runs under the SAME
    union plan.  Returns the same [W, V] stacking as :func:`sweep`."""
    _check_algorithm(algorithm)
    windows = to_numpy(windows).astype(np.int32).reshape(-1, 2)
    plan = _plan(g, tger, windows, plan, access, backend)
    return torch.stack([
        earliest_arrival(g, source, (int(w[0]), int(w[1])), tger, plan=plan, **kwargs)
        for w in windows
    ])


__all__ = ["sliding_windows", "sweep", "sweep_looped", "ALGORITHMS"]
