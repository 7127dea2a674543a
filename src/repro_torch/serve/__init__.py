"""Window-query sweeps."""
from repro_torch.serve.window_sweep import (  # noqa: F401
    sliding_windows,
    sweep,
    sweep_looped,
)
