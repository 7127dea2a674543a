"""Distributed serving and the edge-partitioned graph engine on
``torch.distributed``: meshes, the row partition, collectives over a named
mesh dimension (``graph_engine`` is imported by name)."""
from repro_torch.distributed.collectives import (  # noqa: F401
    MeshAxis,
    all_gather,
    all_reduce,
    mesh_axis,
    world_axis,
)
from repro_torch.distributed.query_shard import (  # noqa: F401
    edge_axis,
    init_process_group,
    make_mesh,
    mesh_shape,
    query_axis,
    query_mesh,
    replicate,
    replicated_arrays,
    row_partition,
    serve_mesh,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    AxisRules,
    constrain,
    current_mesh,
    logical_spec,
    use_mesh,
)
