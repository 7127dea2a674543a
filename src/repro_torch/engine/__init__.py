"""Planner, combine backends and the fixpoint runner."""
from repro_torch.engine.plan import (  # noqa: F401
    AccessPlan,
    make_plan,
    plan_batch,
    plan_query,
)
