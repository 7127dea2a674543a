"""Temporal graph model, TGER time-first index, selective indexing and
edge views."""
from repro_torch.core.temporal_graph import TemporalGraph, from_edges  # noqa: F401
from repro_torch.core.predicates import OrderingPredicateType  # noqa: F401
from repro_torch.core.tger import TGERIndex, build_tger  # noqa: F401
from repro_torch.core.selective import CostModel, decide_access  # noqa: F401
from repro_torch.core.edgemap import (  # noqa: F401
    frontier_from_sources,
    temporal_edge_map,
    temporal_edge_map_batched,
    vertex_map,
)
from repro_torch.engine import AccessPlan, plan_query  # noqa: F401
