"""Selective indexing: cost model + access-method dispatch (paper §5).

Paper Eq. 1-3:

    T_v = c  * [log(deg(v)) + k]        (TGER / index access)
    S_v = c' * deg(v)                   (T-CSR parallel scan)
    C_v = T_v  if beta <= theta_sel else S_v,   beta = k / m

with ``k`` estimated by the SAT histogram.  The decision is made once per
query on the host, from the global histogram; ``k`` rounded up to a
power-of-two rung is the index path's gather budget.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.histogram import estimate_window
from repro_torch.core.tger import TGERIndex

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


__all__ = ["CostModel", "AccessDecision", "decide_access", "budget_for"]
