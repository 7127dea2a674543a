"""Where the port's tensors live, and the one way back to the host.

The entry points (``from_edges``, the generators) put their tensors on the
first CUDA card unless the caller names a device; everything downstream
follows the graph's device.  Without a card the entry points raise instead
of quietly running on the CPU: the CPU is reached only by asking for it,
as the tests do with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` when given, else the first CUDA card; raises when there is
    no card and no ``device``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch paths on the CPU")
    return torch.device("cuda")


def to_numpy(a) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


__all__ = ["resolve_device", "to_numpy"]
