"""Production mesh builders (the port of ``repro/launch/mesh.py``).

``make_production_mesh`` is a function, so importing this module touches no
process group.  Both builders go through ``distributed.query_shard.
make_mesh``: a mesh covers the whole process group, so they raise
``ValueError`` unless the group has exactly the mesh's number of ranks
(256 for one pod, 512 for two).  The backend follows the device (NCCL for
``cuda``, gloo for ``cpu``).

Not ported: ``V5E``, the reference's hardware constants of a TPU chip
(roofline numbers for its dry run); they describe no device the port runs
on.
"""
from __future__ import annotations

from repro_torch.distributed.query_shard import make_mesh as _make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, device=None):
    return _make_mesh(shape, axes, device=device)


__all__ = ["make_production_mesh", "make_mesh"]
