"""PyTorch + CUDA port of the Kairos reproduction (the JAX package
``repro`` is its reference).

Entry points put their tensors on the first CUDA card unless given
``device=``; everything downstream follows the graph's device.  The
re-exports mirror ``repro.core`` for the names this port has.
"""
from repro_torch.device import resolve_device  # noqa: F401
from repro_torch.core import (  # noqa: F401
    CostModel,
    OrderingPredicateType,
    TemporalGraph,
    TGERIndex,
    build_tger,
    decide_access,
    frontier_from_sources,
    from_edges,
    plan_query,
    AccessPlan,
)
