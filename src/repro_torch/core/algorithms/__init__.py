"""Temporal algorithms ported so far: earliest arrival."""
from repro_torch.core.algorithms.paths import (  # noqa: F401
    earliest_arrival,
    earliest_arrival_batched,
    earliest_arrival_multi,
    earliest_arrival_over_view,
)
