"""Temporal algorithms: earliest arrival, latest departure, fastest,
shortest duration, BFS, connected components, k-core, PageRank,
betweenness and overlaps reachability."""
from repro_torch.core.algorithms.paths import (  # noqa: F401
    earliest_arrival,
    earliest_arrival_batched,
    earliest_arrival_multi,
    earliest_arrival_over_view,
    fastest,
    latest_departure,
    shortest_duration,
)
from repro_torch.core.algorithms.bfs import (  # noqa: F401
    temporal_bfs,
    temporal_bfs_batched,
    temporal_bfs_over_view,
)
from repro_torch.core.algorithms.connectivity import (  # noqa: F401
    connected_components_batched,
    temporal_cc,
    temporal_cc_batched,
    temporal_cc_over_view,
)
from repro_torch.core.algorithms.kcore import (  # noqa: F401
    temporal_kcore,
    temporal_kcore_batched,
    temporal_kcore_over_view,
    temporal_coreness,
)
from repro_torch.core.algorithms.pagerank import (  # noqa: F401
    temporal_pagerank,
    temporal_pagerank_batched,
    temporal_pagerank_over_view,
)
from repro_torch.core.algorithms.centrality import (  # noqa: F401
    temporal_betweenness,
    temporal_betweenness_batched,
    temporal_betweenness_over_view,
)
from repro_torch.core.algorithms.reachability import (  # noqa: F401
    overlaps_reachability,
    overlaps_reachability_batched,
    overlaps_reachability_over_view,
)
