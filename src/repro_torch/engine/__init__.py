"""Planner, query batches, combine backends and the fixpoint runner.

    plan = plan_query(g, tger, window, access="auto", backend="pallas_tiled")
    arrival = earliest_arrival(g, src, window, tger, plan=plan)
"""
from repro_torch.engine.plan import (  # noqa: F401
    AccessPlan,
    BACKENDS,
    METHODS,
    decision_for,
    heavy_window_budget,
    make_plan,
    per_vertex_window_budget,
    plan_batch,
    plan_query,
    rung,
)
from repro_torch.engine.queries import (  # noqa: F401
    DEEP_ALGORITHMS,
    DEFAULT_COST_CLASS,
    SOURCE_FREE,
    QueryBatch,
    QueryRow,
    QuerySpec,
    bucket_capacity,
    cost_class_for,
    dedup_rows,
)
from repro_torch.engine.backends import (  # noqa: F401
    ExecutionBackend,
    PallasTiledBackend,
    XlaSegmentBackend,
    combine_for_plan,
    get_backend,
    segment_combine,
)
from repro_torch.engine.fixpoint import FixpointMetrics, FixpointRunner  # noqa: F401

__all__ = [
    "FixpointRunner",
    "FixpointMetrics",
    "AccessPlan",
    "QueryBatch",
    "QueryRow",
    "QuerySpec",
    "SOURCE_FREE",
    "DEEP_ALGORITHMS",
    "DEFAULT_COST_CLASS",
    "cost_class_for",
    "bucket_capacity",
    "plan_query",
    "plan_batch",
    "make_plan",
    "decision_for",
    "per_vertex_window_budget",
    "heavy_window_budget",
    "rung",
    "METHODS",
    "BACKENDS",
    "ExecutionBackend",
    "XlaSegmentBackend",
    "PallasTiledBackend",
    "get_backend",
    "combine_for_plan",
    "segment_combine",
]
