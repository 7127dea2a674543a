"""Synthetic temporal graph generators."""
from repro_torch.data.generators import (  # noqa: F401
    molecule_batch_graph,
    power_law_temporal_graph,
    synthetic_temporal_graph,
    transit_temporal_graph,
)
