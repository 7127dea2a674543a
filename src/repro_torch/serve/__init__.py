"""Window-query sweeps and multi-tenant incremental serving."""
from repro_torch.serve.window_sweep import (  # noqa: F401
    ALGORITHMS,
    QueryBatch,
    QuerySpec,
    SweepState,
    dispatch_log,
    serve_batch,
    sliding_windows,
    sweep,
    sweep_incremental,
    sweep_looped,
)
