"""Selective indexing: cost model + access-method dispatch (paper §5).

Paper Eq. 1-3:

    T_v = c  * [log(deg(v)) + k]        (TGER / index access)
    S_v = c' * deg(v)                   (T-CSR parallel scan)
    C_v = T_v  if beta <= theta_sel else S_v,   beta = k / m

with ``k`` estimated by the SAT histogram.  The decision is made once per
query on the host, from the global histogram; ``k`` rounded up to a
power-of-two rung is the index path's gather budget.
``per_vertex_decisions`` is the paper-granularity form, one decision per
indexed vertex from its own histogram (the estimator study of §6.5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.histogram import Histogram2D, estimate_window
from repro_torch.core.tger import TGERIndex
from repro_torch.device import to_numpy

DEFAULT_C_INDEX = 5.0
DEFAULT_C_SCAN = 1.0
DEFAULT_THETA_SEL = 0.15


@dataclasses.dataclass(frozen=True)
class CostModel:
    c_index: float = DEFAULT_C_INDEX
    c_scan: float = DEFAULT_C_SCAN
    theta_sel: float = DEFAULT_THETA_SEL
    # safety factor on the estimated cardinality before rounding to a rung:
    # under-budgeting would drop edges, so over-provision.
    budget_slack: float = 1.25
    # kept as the reference keeps it (nothing reads it), so that fields(),
    # replace() and equality match
    max_budget_rungs: int = 32

    def index_cost(self, n_edges: int, k: float) -> float:
        return self.c_index * (math.log2(max(n_edges, 2)) + k)

    def scan_cost(self, n_edges: int) -> float:
        return self.c_scan * n_edges

    def choose(self, n_edges: int, k_est: float) -> str:
        """Paper Eq. 3 at call granularity: index iff selective enough AND
        the modeled index cost undercuts the scan."""
        beta = k_est / max(n_edges, 1)
        if beta <= self.theta_sel and self.index_cost(n_edges, k_est) < self.scan_cost(n_edges):
            return "index"
        return "scan"


def budget_for(k_est: float, n_edges: int, model: CostModel) -> int:
    """Round the slack-inflated estimate up to a power-of-two rung, clamped
    to [64, next_pow2(E)]."""
    want = max(int(k_est * model.budget_slack) + 1, 64)
    rung = 1 << (want - 1).bit_length()
    cap = 1 << max(int(n_edges - 1).bit_length(), 6)
    return min(rung, cap)


@dataclasses.dataclass(frozen=True)
class AccessDecision:
    method: str            # "scan" | "index"
    budget: int            # gather budget (index path only)
    k_est: float
    selectivity: float
    index_cost: float
    scan_cost: float


def decide_access(
    idx: TGERIndex,
    n_edges: int,
    window: Tuple[int, int],
    model: CostModel = CostModel(),
    force: Optional[str] = None,
) -> AccessDecision:
    """Access-method decision for a query window (Figure 6's decision tree
    at call granularity), on the host."""
    k_est = float(estimate_window(idx.global_hist, window[0], window[1]))
    beta = k_est / max(n_edges, 1)
    b = budget_for(k_est, n_edges, model)
    dec_method = model.choose(n_edges, k_est) if force is None else force
    if dec_method == "index" and b >= n_edges:
        dec_method = "scan"  # budget degenerated to a full scan
    return AccessDecision(
        method=dec_method,
        budget=b,
        k_est=k_est,
        selectivity=beta,
        index_cost=model.index_cost(n_edges, k_est),
        scan_cost=model.scan_cost(n_edges),
    )


_F32 = np.float32


def _frac_index_rows(edges: np.ndarray, x: np.float32) -> np.ndarray:
    """``histogram._frac_index`` for every row of ``edges`` [H, n+1] at once."""
    n = edges.shape[-1] - 1
    rows = np.arange(edges.shape[0])
    # searchsorted(side="right") on an ascending row: the count of edges <= x
    i = np.clip((edges <= x).sum(axis=-1) - 1, 0, n - 1)
    left, right = edges[rows, i], edges[rows, i + 1]
    span = np.where(right > left, right - left, _F32(1))
    frac = np.where(right > left, (x - left) / span, _F32(0))
    return np.clip(i.astype(_F32) + frac, _F32(0), _F32(n))


def _sat_at_rows(sat: np.ndarray, fi: np.ndarray, fj: np.ndarray) -> np.ndarray:
    """``histogram._sat_at`` for every SAT of ``sat`` [H, n+1, n+1] at once,
    in the same float32 operations and order."""
    n = sat.shape[-1] - 1
    rows = np.arange(sat.shape[0])
    i0 = np.clip(np.floor(fi).astype(np.int64), 0, n - 1)
    j0 = np.clip(np.floor(fj).astype(np.int64), 0, n - 1)
    di = fi - i0.astype(_F32)
    dj = fj - j0.astype(_F32)
    one = _F32(1)
    return (
        sat[rows, i0, j0] * (one - di) * (one - dj)
        + sat[rows, i0, j0 + 1] * (one - di) * dj
        + sat[rows, i0 + 1, j0] * di * (one - dj)
        + sat[rows, i0 + 1, j0 + 1] * di * dj
    )


def _estimate_window_rows(hist: Histogram2D, window_start, window_end) -> np.ndarray:
    """``histogram.estimate_window`` of each histogram of a stacked
    [H, nb+1, nb+1] ``hist``, in one vectorised pass."""
    ws, we = _F32(window_start), _F32(window_end)
    fi_lo = _frac_index_rows(hist.start_edges, ws)
    fi_hi = _frac_index_rows(hist.start_edges, we)
    fj_lo = _frac_index_rows(hist.dur_edges, _F32(0.0))
    fj_hi = _frac_index_rows(hist.dur_edges, we - ws)
    est = (
        _sat_at_rows(hist.sat, fi_hi, fj_hi)
        - _sat_at_rows(hist.sat, fi_lo, fj_hi)
        - _sat_at_rows(hist.sat, fi_hi, fj_lo)
        + _sat_at_rows(hist.sat, fi_lo, fj_lo)
    )
    return np.maximum(est, _F32(0.0))


def per_vertex_decisions(
    idx: TGERIndex,
    degrees,
    window: Tuple[int, int],
    model: CostModel = CostModel(),
):
    """Paper-granularity decision (Eq. 1-3) for every *indexed* vertex:
    ``(use_index[H] bool, k_est[H] float32)`` as tensors on the index's
    device.  ``k_est`` is each vertex's own histogram estimate, computed on
    the host in float32 in the reference's order; ``degrees`` is a [V]
    tensor or array (e.g. ``g.out_degree``)."""
    k_est = _estimate_window_rows(idx.vertex_hist, window[0], window[1])
    ids = np.maximum(to_numpy(idx.indexed_ids), 0)
    deg = to_numpy(degrees)[ids].astype(_F32)
    beta = k_est / np.maximum(deg, _F32(1.0))
    t_v = _F32(model.c_index) * (np.log2(np.maximum(deg, _F32(2.0))) + k_est)
    s_v = _F32(model.c_scan) * deg
    use_index = (beta <= _F32(model.theta_sel)) & (t_v < s_v)
    dev = idx.indexed_ids.device
    return torch.as_tensor(use_index, device=dev), torch.as_tensor(k_est, device=dev)


def calibrate_constants(scan_time_per_edge: float, index_time_per_edge: float) -> CostModel:
    """Build a CostModel from measured per-edge costs (benchmarks feed this)."""
    c_scan = 1.0
    c_index = max(index_time_per_edge / max(scan_time_per_edge, 1e-12), 1e-3)
    return CostModel(c_index=c_index, c_scan=c_scan)


__all__ = [
    "CostModel",
    "AccessDecision",
    "decide_access",
    "per_vertex_decisions",
    "budget_for",
    "calibrate_constants",
]
