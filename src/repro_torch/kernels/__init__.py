"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; ``build`` compiles and binds them at first use.

Each kernel wrapper counts its own launches (``<wrapper>.launches``);
``launch_counts`` / ``reset_launch_counts`` read and clear them all.
"""


def _kernels() -> tuple:
    """Every kernel wrapper of the port, in order K1, K2, K3, K4."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.segment_spmm import segment_spmm_tiles
    from repro_torch.kernels.temporal_edgemap import (
        segment_min_tiles,
        temporal_relax_min_tiles,
    )

    return (segment_min_tiles, temporal_relax_min_tiles, segment_spmm_tiles,
            decode_attention)


def reset_launch_counts() -> None:
    for k in _kernels():
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in _kernels()}


__all__ = ["launch_counts", "reset_launch_counts"]
