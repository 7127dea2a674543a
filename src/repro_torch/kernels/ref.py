"""Plain oracles for the kernels' semantics, independent of the tile layout."""
from __future__ import annotations

import torch

from repro_torch.kernels.temporal_edgemap import INT_INF


def temporal_relax_min_ref(dst, arr_src, t_start, t_end, valid, window,
                           n_vertices: int, strict: bool = False):
    """out[v] = min over valid edges into v (window + ordering predicate
    against the source arrival) of t_end; INT_INF elsewhere.  ``arr_src``
    is the source arrival gathered per edge, non-frontier sources
    pre-masked to INT_INF."""
    ta, tb = int(window[0]), int(window[1])
    follows = (arr_src < t_start) if strict else (arr_src <= t_start)
    ok = valid & (t_start >= ta) & (t_end <= tb) & follows & (arr_src < INT_INF)
    cand = torch.where(ok, t_end, INT_INF)
    ids = torch.where(ok, dst.long(), 0)
    out = torch.full((n_vertices,), INT_INF, dtype=torch.int32, device=dst.device)
    return out.scatter_reduce_(0, ids, cand, "amin", include_self=True)


def segment_spmm_ref(dst, messages, valid, n_vertices: int):
    """out[v, :] = sum of ``messages`` [E, D] over the valid edges into v."""
    m = torch.where(valid[:, None], messages, 0.0)
    ids = torch.where(valid, dst.long(), 0)
    out = torch.zeros((n_vertices,) + tuple(messages.shape[1:]),
                      dtype=messages.dtype, device=messages.device)
    return out.index_add_(0, ids, m)


__all__ = ["temporal_relax_min_ref", "segment_spmm_ref"]
