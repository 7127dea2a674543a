"""Temporal PageRank: damped power iteration over the window-valid edge set
(paper §6.1 runs 100 iterations with a [t_a, t_b] input window).

The window-validity matrix, degrees and dangling sets are iteration-
invariant: they are computed once on the FixpointRunner's hoisted view, and
each power iteration is one runner step with a [W, ·] batched sum combine —
K3 on a tiled scan plan.  The iteration is a host loop with no sync inside.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.edgemap import EdgeView, ensure_plan, union_window, view_for_plan
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex
from repro_torch.device import to_numpy
from repro_torch.engine.backends import segment_combine_windows
from repro_torch.engine.fixpoint import FixpointRunner
from repro_torch.engine.plan import AccessPlan


def temporal_pagerank(
    g: TemporalGraph,
    window: Tuple[int, int],
    tger: Optional[TGERIndex] = None,
    *,
    damping: float = 0.85,
    n_iters: int = 100,
    plan: Optional[AccessPlan] = None,
) -> torch.Tensor:
    """pr[V] within ``window``: the W=1 row of the batched iteration."""
    windows = np.asarray([[int(window[0]), int(window[1])]], np.int32)
    return temporal_pagerank_batched(g, windows, tger, damping=damping,
                                     n_iters=n_iters, plan=plan)[0]


def _pagerank_relax(edges, state):
    pr_src, inv_src = state
    return pr_src * inv_src, None


def temporal_pagerank_over_view(
    edges: EdgeView,
    windows,                        # [Q, 2]
    *,
    plan: AccessPlan,
    n_vertices: int,
    sources=None,                   # accepted for signature uniformity: must be None
    damping: float = 0.85,
    n_iters: int = 100,
    init: Optional[torch.Tensor] = None,   # [Q, V] warm start
) -> torch.Tensor:
    """The batched power iteration over a prebuilt (union-covering) view:
    pr[q, v] within windows[q].  PageRank is source-free, so ``sources``
    must be None.  ``init`` warm-starts the iteration; the finite-iteration
    result then differs from a cold start's by the residual.

    The frontier ladder is a no-op here, as in the JAX package: every
    vertex is live every iteration (no frontier to shrink), and a sparse
    float sum would reassociate the reduction, so a plan with ``ladder >
    0`` runs this same dense iteration."""
    if sources is not None:
        raise ValueError("temporal_pagerank is source-free: pass sources=None")
    runner = FixpointRunner.for_view(edges, windows=windows, plan=plan,
                                     n_vertices=n_vertices)
    V = n_vertices
    W = runner.windows.shape[0]
    # the degree reduce goes into src: the native-order layout does not apply
    out_deg = segment_combine_windows(runner.valid.to(torch.float32), edges.src,
                                      V, "sum")                        # [W, V]
    inv_deg = torch.where(out_deg > 0, 1.0 / torch.clamp(out_deg, min=1.0), 0.0)
    dangling = out_deg == 0
    if init is None:
        pr = torch.full((W, V), 1.0 / V, dtype=torch.float32, device=runner.device)
    else:
        pr = torch.as_tensor(init, dtype=torch.float32, device=runner.device)
    for _ in range(n_iters):
        agg, _ = runner.step(None, (pr, inv_deg), _pagerank_relax, "sum")
        dangling_mass = torch.where(dangling, pr, 0.0).sum(dim=1, keepdim=True) / V
        pr = (1.0 - damping) / V + damping * (agg + dangling_mass)
    return pr


def temporal_pagerank_batched(
    g: TemporalGraph,
    windows,                        # [W, 2] query windows
    tger: Optional[TGERIndex] = None,
    *,
    damping: float = 0.85,
    n_iters: int = 100,
    plan: Optional[AccessPlan] = None,
) -> torch.Tensor:
    """pr[w, v] over all W windows from ONE union-window view: per-window
    validity masks and one [W, ·] sum combine per iteration.  Degrees (and
    so the dangling sets) are per window."""
    plan = ensure_plan(plan)
    windows = to_numpy(windows).astype(np.int32).reshape(-1, 2)
    edges = view_for_plan(g, tger, union_window(windows), plan)
    return temporal_pagerank_over_view(edges, windows, plan=plan,
                                       n_vertices=g.n_vertices,
                                       damping=damping, n_iters=n_iters)


__all__ = [
    "temporal_pagerank",
    "temporal_pagerank_batched",
    "temporal_pagerank_over_view",
]
