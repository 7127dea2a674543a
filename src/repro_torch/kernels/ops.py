"""Wrappers binding the relax kernel (K2) and the segment-sum kernel (K3)
to plain edge arrays.

``relax_min`` applies the destination-tile layout to the edge arrays (the
gathers stay outside the kernel), launches K2 and unpacks the tiles to a
dense [V] result; ``earliest_arrival_kernel`` drives it to a fixpoint with
one host sync per round.  ``spmm`` does the same for K3: [E, D] messages in,
[V, D] sums out.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hostcache import identity_cache
from repro_torch.device import to_numpy
from repro_torch.kernels.layout import TileLayout, build_tile_layout
from repro_torch.kernels.segment_spmm import segment_spmm_tiles
from repro_torch.kernels.temporal_edgemap import INT_INF, temporal_relax_min_tiles


def prepare_layout(dst, n_vertices: int, tile_v: int = 512,
                   block_e: int = 1024) -> TileLayout:
    """The tile layout of ``dst``, its arrays as int32 tensors on ``dst``'s
    device (the CPU for host arrays).  Built once per ``dst`` and tile
    shape: the planner and direct callers share the one copy."""
    return _layout_cached(dst, int(n_vertices), int(tile_v), int(block_e))


@identity_cache(16)
def _layout_cached(dst, n_vertices: int, tile_v: int, block_e: int) -> TileLayout:
    layout = build_tile_layout(to_numpy(dst), n_vertices, tile_v, block_e)
    device = dst.device if isinstance(dst, torch.Tensor) else "cpu"
    block_tile = torch.as_tensor(layout.block_tile, device=device)
    tile_starts(block_tile, layout.n_tiles)  # derived here, once per layout
    return dataclasses.replace(
        layout, perm=torch.as_tensor(layout.perm, device=device), block_tile=block_tile)


@identity_cache(16)
def tile_starts(block_tile, n_tiles: int):
    """Each tile's first block, int32 [n_tiles + 1] on ``block_tile``'s
    device: tile t owns blocks [s[t], s[t + 1]) of the nondecreasing
    ``block_tile``, none where the two are equal.  The tile-min kernels read
    it to find the tiles that own no block; cached per ``block_tile``."""
    probe = torch.arange(n_tiles + 1, dtype=torch.int32, device=block_tile.device)
    return torch.searchsorted(block_tile, probe, out_int32=True)


def _gather_padded(arr, perm, fill):
    out = arr[perm.clamp(min=0).long()]
    return torch.where(perm >= 0, out, fill)


def relax_min(
    layout: TileLayout,
    dst,
    arrival,         # i32[V] per-vertex state (source side)
    src,
    t_start,
    t_end,
    frontier,        # bool[V]
    window,
    *,
    strict: bool = False,
):
    """One fused temporal relax through K2: returns cand[V] minima."""
    perm = torch.as_tensor(layout.perm, device=arrival.device)
    arr_masked = torch.where(frontier, arrival, INT_INF)
    arr_src = _gather_padded(arr_masked[src.long()], perm, INT_INF)
    dst_g = _gather_padded(dst, perm, 0)
    dst_local = dst_g - (dst_g // layout.tile_v) * layout.tile_v
    ts_g = _gather_padded(t_start, perm, 0)
    te_g = _gather_padded(t_end, perm, 0)
    valid = (perm >= 0).to(torch.int32)

    tiles = temporal_relax_min_tiles(
        dst_local, arr_src, ts_g, te_g, valid,
        torch.as_tensor(layout.block_tile, device=arrival.device),
        (int(window[0]), int(window[1])), layout.n_tiles,
        tile_v=layout.tile_v, block_e=layout.block_e, strict=strict,
    )
    return tiles.reshape(-1)[:arrival.shape[0]]


def earliest_arrival_kernel(
    g,
    layout: TileLayout,
    source: int,
    window,
    *,
    strict: bool = False,
    max_rounds: int = 0,
):
    """Earliest arrival with every round one K2 launch; the host loop stops
    when no vertex improved (one ``bool(frontier.any())`` sync per round)."""
    V = g.n_vertices
    arrival = torch.full((V,), INT_INF, dtype=torch.int32, device=g.device)
    arrival[source] = int(window[0])
    frontier = torch.zeros(V, dtype=torch.bool, device=g.device)
    frontier[source] = True
    max_rounds = max_rounds or V + 1
    for _ in range(max_rounds):
        cand = relax_min(
            layout, g.dst, arrival, g.src, g.t_start, g.t_end, frontier,
            window, strict=strict,
        )
        new = torch.minimum(arrival, cand)
        frontier = new < arrival
        if not bool(frontier.any()):
            return new
        arrival = new
    return arrival


def spmm(
    layout: TileLayout,
    dst,
    messages,        # f32[E, D] per-edge messages (already gathered/scaled)
    *,
    n_vertices: int,
    valid_edges=None,
):
    """Segment-sum of ``messages`` by destination through K3: returns
    [n_vertices, D].  The layout's tile shape is used throughout."""
    perm = torch.as_tensor(layout.perm, device=messages.device)
    dst_g = _gather_padded(dst, perm, 0)
    dst_local = dst_g - (dst_g // layout.tile_v) * layout.tile_v
    msg_g = messages[perm.clamp(min=0).long()].contiguous()
    valid = perm >= 0
    if valid_edges is not None:
        valid = valid & _gather_padded(valid_edges, perm, False)
    tiles = segment_spmm_tiles(
        dst_local, msg_g, valid.to(torch.int32),
        torch.as_tensor(layout.block_tile, device=messages.device), layout.n_tiles,
        tile_v=layout.tile_v, block_e=layout.block_e,
    )
    return tiles.reshape(-1, messages.shape[-1])[:n_vertices]


__all__ = ["prepare_layout", "tile_starts", "relax_min", "earliest_arrival_kernel", "spmm"]
