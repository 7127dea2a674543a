"""Destination-tile edge layout for the tile-min kernels.

Edges are grouped by destination tile (dst // tile_v) and each group is
padded to a multiple of the edge-block size, so every edge block belongs
to exactly one output tile.  The grouping is host numpy, built once per
graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """Edge order + block->tile mapping for one (graph, tile_v, block_e).

    ``perm`` and ``block_tile`` are host arrays from ``build_tile_layout``;
    ``kernels.ops.prepare_layout``, which the planner calls, holds them as
    tensors on the graph's device instead."""

    perm: np.ndarray         # i32[Ep] edge ids in grouped order (padding = -1)
    block_tile: np.ndarray   # i32[NB] output tile owned by each edge block
    n_blocks: int
    n_tiles: int
    tile_v: int
    block_e: int
    n_edges_padded: int


def build_tile_layout(dst: np.ndarray, n_vertices: int, tile_v: int, block_e: int) -> TileLayout:
    dst = np.asarray(dst)
    n_tiles = -(-n_vertices // tile_v)
    tile_of_edge = dst // tile_v
    order = np.argsort(tile_of_edge, kind="stable").astype(np.int64)

    perm_parts = []
    block_tiles = []
    sorted_tiles = tile_of_edge[order]
    bounds = np.searchsorted(sorted_tiles, np.arange(n_tiles + 1))
    for t in range(n_tiles):
        grp = order[bounds[t]: bounds[t + 1]]
        if grp.size == 0:
            continue
        pad = (-grp.size) % block_e
        grp = np.concatenate([grp, np.full(pad, -1, np.int64)])
        perm_parts.append(grp)
        block_tiles.extend([t] * (grp.size // block_e))
    if not perm_parts:  # empty graph: one padded block for tile 0
        perm_parts = [np.full(block_e, -1, np.int64)]
        block_tiles = [0]
    perm = np.concatenate(perm_parts).astype(np.int32)
    block_tile = np.asarray(block_tiles, np.int32)
    return TileLayout(
        perm=perm,
        block_tile=block_tile,
        n_blocks=len(block_tile),
        n_tiles=n_tiles,
        tile_v=tile_v,
        block_e=block_e,
        n_edges_padded=perm.size,
    )


__all__ = ["TileLayout", "build_tile_layout"]
