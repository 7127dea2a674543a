"""How a plan's combines execute.

Two backends behind one ``ExecutionBackend`` protocol (``get_backend``),
named as in the JAX package:

  * ``xla_segment`` — masked ``scatter_reduce_`` (amin / amax / sum) into an
    identity-filled buffer;
  * ``pallas_tiled`` — the destination-tile kernels: the int32 min-combine
    (K1, ``kernels/temporal_edgemap.py``) and the float32 sum-combine (K3,
    ``kernels/segment_spmm.py``) of a scan-method, out-direction view; every
    other combine takes the segment path, so the backend is a performance
    choice, never a correctness one.

Segment ids are prepared once per view (:func:`segments_for`): the int64
scatter index, and for the tiled kernels the layout gather and each slot's
local destination.  A fixpoint round then pays only the value gathers.

Under a plan whose ``edge_axis`` is set (an edge-sharded solve: this rank
holds one chunk of the view's edges) every combine takes the segment path
and ends with ONE collective over that mesh dimension: min, max and sum
are associative and identity-padded, so the combined partials equal the
unsharded reduce (a float sum up to its summation order).  The tile layout
is a whole-graph grouping, so K1 and K3 run only where the edge axis is
replicated.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Protocol

import torch

from repro_torch.distributed.collectives import all_reduce
from repro_torch.engine.plan import AccessPlan
from repro_torch.kernels.segment_spmm import segment_spmm_tiles
from repro_torch.kernels.temporal_edgemap import INT_INF, segment_min_tiles

INT_NEG_INF = -(2**31)
_REDUCE = {"min": "amin", "max": "amax", "sum": "sum"}


def _identity(combine: str, dtype: torch.dtype):
    floating = dtype.is_floating_point
    if combine == "min":
        return float("inf") if floating else INT_INF
    if combine == "max":
        return float("-inf") if floating else INT_NEG_INF
    if combine == "sum":
        return 0
    raise ValueError(combine)


class TileGather(NamedTuple):
    """A view's segment ids in the plan's tile layout order.  Padding slots
    index one past the view's end, where the gathers append the identity."""

    index: torch.Tensor      # i64[Ep] view slot of each layout slot (K on padding)
    dst_local: torch.Tensor  # i32[Ep] segment id within its tile (0 on padding)
    lane: torch.Tensor       # i32[Ep] 1 on edge slots, 0 on padding


class Segments(NamedTuple):
    """Segment ids prepared once per view."""

    ids: torch.Tensor                 # i64[K]
    tiles: Optional[TileGather] = None


def _padded(values: torch.Tensor, fill, dim: int = -1) -> torch.Tensor:
    """``values`` with one ``fill`` slot appended on axis ``dim``."""
    shape = list(values.shape)
    shape[dim] = 1
    return torch.cat([values, values.new_full(shape, fill)], dim=dim)


def _tile_gather(plan: AccessPlan, segment_ids: torch.Tensor) -> TileGather:
    perm = plan.layout_perm
    index = torch.where(perm >= 0, perm.long(), segment_ids.shape[0])
    seg = _padded(segment_ids, 0)[index].to(torch.int32)
    dst_local = seg - (seg // plan.tile_v) * plan.tile_v
    return TileGather(index, dst_local.contiguous(), (perm >= 0).to(torch.int32))


def segments_for(plan: Optional[AccessPlan], segment_ids, *,
                 use_layout: bool = False) -> Segments:
    """Prepare ``segment_ids`` for :func:`combine_for_plan`.  The layout
    part is built for a ``pallas_tiled`` plan when ``use_layout`` asserts
    the ids are in the edge order the plan's layout was built from (scan
    view, reduce into destination); whether a combine may then run the
    kernel is :meth:`PallasTiledBackend._supports`'s decision."""
    if isinstance(segment_ids, Segments):
        return segment_ids
    ids = segment_ids.long()
    tiles = None
    if (plan is not None and use_layout and plan.backend == "pallas_tiled"
            and plan.edge_axis is None):
        tiles = _tile_gather(plan, ids)
    return Segments(ids, tiles)


def segment_combine(values, segment_ids, num_segments: int, combine: str,
                    mask=None, axis=None):
    """Masked segment-reduce of ``values`` [K, ...] by ``segment_ids`` [K];
    invalid lanes contribute the identity, empty segments hold it.  A
    float32 sum accumulates in float64 and rounds once: added one by one in
    float32, a hub's sum of many similar terms drifts by up to its term
    count times float32's epsilon.

    ``axis`` (a :class:`~repro_torch.distributed.MeshAxis`) names the mesh
    dimension the edge axis of ``values`` is sharded over: this rank's
    partial then meets the others' in one all-reduce (a float32 sum's
    partials in float64, before the one rounding)."""
    ident = _identity(combine, values.dtype)
    ids = segment_ids.long()
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim()))
        values = torch.where(m, values, ident)
        # A masked lane adds the identity, which changes nothing wherever it
        # lands: it keeps its own segment (clamped into range) rather than
        # all masked lanes meeting at segment 0, where on the card their
        # atomics would serialise on one address.
        ids = torch.where(mask, ids, ids.clamp(0, max(num_segments - 1, 0)))
    if values.dim() > 1:
        ids = ids.reshape(ids.shape + (1,) * (values.dim() - 1)).expand_as(values)
    out_dtype = values.dtype
    if combine == "sum" and out_dtype == torch.float32:
        values = values.double()
    out = torch.full((num_segments,) + tuple(values.shape[1:]), ident,
                     dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, ids, values, _REDUCE[combine], include_self=True)
    if axis is not None:
        all_reduce(out, combine, axis)
    return out.to(out_dtype)


def segment_combine_windows(values, segment_ids, num_segments: int,
                            combine: str, masks=None, axis=None):
    """Batched masked segment-reduce over a shared edge set: ``values``
    [W, K, ...], ``masks`` [W, K], ``segment_ids`` [K] shared.  Returns
    [W, num_segments, ...] from one scatter over a flattened window axis
    (and with ``axis``, one collective for all W)."""
    W, K = values.shape[:2]
    rows = torch.arange(W, device=values.device)[:, None] * num_segments
    ids = (segment_ids.long()[None, :] + rows).expand(W, K).reshape(-1)
    flat = values.reshape((W * K,) + tuple(values.shape[2:]))
    out = segment_combine(flat, ids, W * num_segments, combine,
                          mask=None if masks is None else masks.reshape(-1),
                          axis=axis)
    return out.reshape((W, num_segments) + tuple(values.shape[2:]))


class ExecutionBackend(Protocol):
    """Backend protocol: execute a (masked) segment combine, single-window
    or batched over a window axis sharing one edge set."""

    name: str

    def combine(self, plan: Optional[AccessPlan], values, segment_ids,
                num_segments: int, op: str, mask=None):
        ...

    def combine_windows(self, plan: Optional[AccessPlan], values, segment_ids,
                        num_segments: int, op: str, masks=None):
        ...


class XlaSegmentBackend:
    """The masked segment-reduce path (``scatter_reduce_``); the name is the
    JAX package's, so a plan's backend string finds it."""

    name = "xla_segment"

    def combine(self, plan, values, segment_ids, num_segments, op, mask=None):
        del plan
        return segment_combine(values, segments_for(None, segment_ids).ids, num_segments,
                               op, mask=mask)

    def combine_windows(self, plan, values, segment_ids, num_segments, op,
                        masks=None):
        del plan
        return segment_combine_windows(values, segments_for(None, segment_ids).ids,
                                       num_segments, op, masks=masks)


class PallasTiledBackend:
    """The destination-tile kernels, selected by the plan's layout (the
    name is the JAX package's, so plans and cache keys compare equal).

    ``segment_ids`` must be in the edge order the layout was built from
    (the graph's native order; callers gate on that)."""

    name = "pallas_tiled"

    def _supports(self, plan, values, num_segments, op) -> bool:
        if plan is None or plan.layout_perm.shape[0] == 0:
            return False
        if plan.n_edges and values.shape[0] != plan.n_edges:
            return False
        if num_segments > plan.n_tiles * plan.tile_v:
            return False
        if op == "min":
            return values.dim() == 1 and values.dtype == torch.int32
        # K3 takes float32 messages; other float types take the segment path
        return op == "sum" and values.dim() in (1, 2) and values.dtype == torch.float32

    def combine(self, plan, values, segment_ids, num_segments, op, mask=None):
        seg = segments_for(plan, segment_ids, use_layout=True)
        if not self._supports(plan, values, num_segments, op):
            return segment_combine(values, seg.ids, num_segments, op, mask=mask)
        if op == "min":
            return self._combine_min(plan, values, seg.tiles, num_segments, mask)
        return self._combine_sum(plan, values, seg.tiles, num_segments, mask)

    def combine_windows(self, plan, values, segment_ids, num_segments, op,
                        masks=None):
        seg = segments_for(plan, segment_ids, use_layout=True)
        if not self._supports(plan, values[0], num_segments, op):
            return segment_combine_windows(values, seg.ids, num_segments, op,
                                           masks=masks)
        if op == "min":
            return self._combine_min_windows(plan, values, seg.tiles,
                                             num_segments, masks)
        return self._combine_sum_windows(plan, values, seg.tiles, num_segments,
                                         masks)

    def _combine_min(self, plan, values, tiles: TileGather, num_segments, mask):
        cand = values if mask is None else torch.where(mask, values, INT_INF)
        cand_g = _padded(cand, INT_INF)[tiles.index]
        out = segment_min_tiles(
            tiles.dst_local, cand_g, plan.layout_block_tile, plan.n_tiles,
            tile_v=plan.tile_v, block_e=plan.block_e,
        )
        return out.reshape(-1)[:num_segments]

    def _combine_min_windows(self, plan, values, tiles: TileGather,
                             num_segments, masks):
        """All W windows in ONE K1 launch (W is the kernel's grid y)."""
        cand = values if masks is None else torch.where(masks, values, INT_INF)
        cand_g = _padded(cand, INT_INF)[:, tiles.index]
        out = segment_min_tiles(
            tiles.dst_local, cand_g, plan.layout_block_tile, plan.n_tiles,
            tile_v=plan.tile_v, block_e=plan.block_e,
        )
        return out.reshape(values.shape[0], -1)[:, :num_segments]

    def _combine_sum(self, plan, values, tiles: TileGather, num_segments, mask):
        return self._combine_sum_windows(
            plan, values[None], tiles, num_segments,
            None if mask is None else mask[None])[0]

    def _combine_sum_windows(self, plan, values, tiles: TileGather,
                             num_segments, masks):
        """All W windows in ONE K3 launch (W is the kernel's grid y)."""
        msgs = values[..., None] if values.dim() == 2 else values    # [W, K, F]
        n_w = msgs.shape[0]
        msg_g = _padded(msgs, 0.0, dim=1)[:, tiles.index]
        if masks is None:
            valid = tiles.lane.expand(n_w, -1).contiguous()
        else:
            valid = _padded(masks, False)[:, tiles.index].to(torch.int32)
        out = segment_spmm_tiles(
            tiles.dst_local, msg_g, valid, plan.layout_block_tile, plan.n_tiles,
            tile_v=plan.tile_v, block_e=plan.block_e,
        )
        out = out.reshape(n_w, -1, msgs.shape[-1])[:, :num_segments]
        return out[..., 0] if values.dim() == 2 else out


_TILED = PallasTiledBackend()
_BACKENDS = {"xla_segment": XlaSegmentBackend(), "pallas_tiled": _TILED}


def get_backend(name: str) -> ExecutionBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; have {sorted(_BACKENDS)}") from None


def combine_for_plan(
    plan: Optional[AccessPlan],
    values,
    segment_ids,
    num_segments: int,
    op: str,
    mask=None,
    *,
    use_layout: bool = False,
):
    """Plan-directed combine.  ``segment_ids`` is a tensor or prepared
    :class:`Segments`; ``use_layout`` (for a raw tensor) asserts the ids are
    in the layout's edge order, and only then may the tiled kernels run.
    A plan with ``edge_axis`` takes the segment path and one collective."""
    seg = segments_for(plan, segment_ids, use_layout=use_layout)
    axis = None if plan is None else plan.edge_axis
    if seg.tiles is not None and axis is None:
        return _TILED.combine(plan, values, seg, num_segments, op, mask=mask)
    return segment_combine(values, seg.ids, num_segments, op, mask=mask, axis=axis)


def combine_windows_for_plan(
    plan: Optional[AccessPlan],
    values,           # [W, K, ...]
    segment_ids,      # [K] shared across windows, or Segments
    num_segments: int,
    op: str,
    masks=None,       # [W, K]
    *,
    use_layout: bool = False,
):
    """Batched plan-directed combine: W reductions over one shared edge set,
    returning [W, num_segments, ...]; same eligibility (and ``edge_axis``
    contract) as :func:`combine_for_plan`."""
    seg = segments_for(plan, segment_ids, use_layout=use_layout)
    axis = None if plan is None else plan.edge_axis
    if seg.tiles is not None and axis is None:
        return _TILED.combine_windows(plan, values, seg, num_segments, op,
                                      masks=masks)
    return segment_combine_windows(values, seg.ids, num_segments, op, masks=masks,
                                   axis=axis)


__all__ = [
    "ExecutionBackend",
    "XlaSegmentBackend",
    "PallasTiledBackend",
    "get_backend",
    "Segments",
    "segments_for",
    "segment_combine",
    "segment_combine_windows",
    "combine_for_plan",
    "combine_windows_for_plan",
]
