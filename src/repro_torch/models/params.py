"""Parameter trees of the GNN, NequIP and MIND models: random draws from a
``torch.Generator`` on the parameters' device, and the reference's trees
(numpy arrays) carried over.  A model describes its tree once as a layout
whose leaves are ``(shape, scale)`` or ``(shape, scale, dtype)``: zeros
where the scale is None, else a normal draw times the scale, in the
model's dtype unless the leaf names its own.  On the ``meta`` device with
no generator (the dry run) the tree holds empty tensors of those shapes
and dtypes, and nothing is drawn."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def draw_params(layout, dtype, generator: torch.Generator, device=None):
    """Tensors for a ``(shape, scale)`` layout tree: zeros where the scale
    is None, else normal draws from ``generator`` times the scale (drawn in
    place, so a large table needs no second copy).  The generator must be
    on ``device`` (the first CUDA card unless given).  On ``meta`` with no
    generator the leaves are empty tensors (nothing is drawn)."""
    device = resolve_device(device)
    if device.type == "meta" and generator is None:
        return tree_map(lambda leaf: torch.empty(
            leaf[0], dtype=leaf[2] if len(leaf) > 2 else dtype, device=device), layout)
    gdev = generator.device
    if gdev.type != device.type or device.index not in (None, gdev.index):
        raise ValueError(f"the generator is on {gdev}, the weights go to {device}")

    def draw(leaf):
        shape, scale = leaf[:2]
        dt = leaf[2] if len(leaf) > 2 else dtype
        if scale is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, scale, generator=generator)

    with torch.no_grad():
        return tree_map(draw, layout)


def carry_params(layout, tree, dtype, device=None):
    """The reference's parameter tree (numpy arrays) as tensors on
    ``device``, checked leaf by leaf against ``layout``'s shapes."""
    device = resolve_device(device)

    def one(leaf, a):
        a = np.array(a)  # a writable copy (JAX's arrays are read-only)
        if tuple(a.shape) != tuple(leaf[0]):
            raise ValueError(f"parameter shape {a.shape}, the config says {leaf[0]}")
        return torch.from_numpy(a).to(device=device,
                                       dtype=leaf[2] if len(leaf) > 2 else dtype)

    return tree_map(one, layout, tree)


__all__ = ["draw_params", "carry_params"]
