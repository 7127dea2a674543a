"""Window-query sweeps, multi-tenant incremental serving (sharded over a
``torch.distributed`` mesh with ``mesh=``) and the graph serving daemon."""
from repro_torch.serve.window_sweep import (  # noqa: F401
    ALGORITHMS,
    QueryBatch,
    QuerySpec,
    SweepState,
    dispatch_log,
    query_mesh,
    serve_batch,
    sliding_windows,
    sweep,
    sweep_incremental,
    sweep_looped,
)
from repro_torch.core.coldstore import ColdStore  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    GraphBatchServer,
    GraphServeStats,
    ServeEngine,
    TickReport,
)
