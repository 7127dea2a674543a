"""Planner, query batches, combine backends and the fixpoint runner."""
from repro_torch.engine.plan import (  # noqa: F401
    AccessPlan,
    decision_for,
    make_plan,
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
