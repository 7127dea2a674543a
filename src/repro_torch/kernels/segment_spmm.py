"""Tiled segment-sum kernel (K3) over the destination-tile edge layout,
beside its plain PyTorch version.

``segment_spmm_tiles`` sums per-edge message rows into [n_tiles, tile_v, D]
output tiles, masked by ``valid`` — one window, or W windows in one launch.
The CUDA source is ``csrc/segment_spmm.cu``.  Kernel and plain version
both accumulate in float64 and round once to float32; the kernel's atomics
add in no fixed order, so bit-reproducibility is not guaranteed.

Dispatch is by the tensors' device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  The wrapper counts its launches
in ``segment_spmm_tiles.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.temporal_edgemap import _MAX_SMEM, _check, _check_layout, _device_for


def _check_messages(name, dst_local, messages, valid, ep):
    if messages.dtype != torch.float32:
        raise TypeError(f"{name}: messages must be float32, got {messages.dtype}")
    if messages.device != dst_local.device:
        raise ValueError(f"{name}: messages is on {messages.device}, "
                         f"expected {dst_local.device}")
    if not messages.is_contiguous():
        raise ValueError(f"{name}: messages must be contiguous")
    if messages.dim() not in (2, 3) or messages.shape[-2] != ep or messages.shape[-1] < 1:
        raise ValueError(f"{name}: messages has shape {tuple(messages.shape)}, "
                         f"expected ({ep}, D) or (W, {ep}, D) with D >= 1")
    if tuple(valid.shape) != tuple(messages.shape[:-1]):
        raise ValueError(f"{name}: valid has shape {tuple(valid.shape)}, "
                         f"expected {tuple(messages.shape[:-1])}")


def segment_spmm_tiles_plain(dst_local, messages, valid, block_tile, n_tiles: int, *,
                             tile_v: int = 256, block_e: int = 512):
    """Plain version of K3: ``index_add_`` over the global slot
    ``block_tile[b] * tile_v + dst_local``, with invalid and out-of-range
    lanes zeroed.  ``messages`` is [Ep, D] or [W, Ep, D], ``valid`` [Ep] or
    [W, Ep].  The sums accumulate in float64 and round once to float32, as
    the kernel's do (one by one in float32, a hub's sum of many similar
    terms drifts by up to its term count times float32's epsilon)."""
    windowed = messages.dim() == 3
    m = messages.reshape((-1,) + tuple(messages.shape[-2:]))
    v = valid.reshape(-1, valid.shape[-1])
    n_w, _, d = m.shape
    tile = block_tile.long().repeat_interleave(block_e)
    loc = dst_local.long()
    ok = (loc >= 0) & (loc < tile_v) & (tile >= 0) & (tile < n_tiles)
    size = n_tiles * tile_v
    idx = torch.where(ok, tile * tile_v + loc, 0)
    rows = torch.arange(n_w, device=m.device)[:, None] * size
    keep = (v != 0) & ok[None, :]
    vals = torch.where(keep[..., None], m.double(), 0.0)
    out = torch.zeros((n_w * size, d), dtype=torch.float64, device=m.device)
    out.index_add_(0, (idx[None, :] + rows).reshape(-1), vals.reshape(-1, d))
    out = out.to(torch.float32).view(n_w, n_tiles, tile_v, d)
    return out if windowed else out[0]


def segment_spmm_tiles(dst_local, messages, valid, block_tile, n_tiles: int, *,
                       tile_v: int = 256, block_e: int = 512):
    """K3: out[(W,) n_tiles, tile_v, D] per-tile sums of the ``messages``
    rows ([Ep, D] or [W, Ep, D]) whose ``valid`` lane ([Ep] or [W, Ep],
    int32) is nonzero, grouped by ``dst_local``; zero elsewhere."""
    name = "segment_spmm_tiles"
    ep = _check_layout(name, dst_local, block_tile, n_tiles, tile_v, block_e)
    _check(name, dst_local.device, dst_local=dst_local, valid=valid,
           block_tile=block_tile)
    _check_messages(name, dst_local, messages, valid, ep)
    if tile_v * 8 > _MAX_SMEM:
        raise ValueError(f"{name}: tile_v={tile_v} exceeds the float64 shared tile")
    if _device_for(name, messages) == "cpu":
        return segment_spmm_tiles_plain(dst_local, messages, valid, block_tile,
                                        n_tiles, tile_v=tile_v, block_e=block_e)
    n_windows = messages.shape[0] if messages.dim() == 3 else 1
    d = messages.shape[-1]
    out = torch.zeros((n_windows, n_tiles, tile_v, d), dtype=torch.float64,
                      device=messages.device)
    lib = build.library("segment_spmm")
    rc = lib.segment_spmm_tiles_launch(
        dst_local.data_ptr(), messages.data_ptr(), valid.data_ptr(),
        block_tile.data_ptr(), out.data_ptr(), block_tile.shape[0], n_tiles,
        tile_v, block_e, d, n_windows,
        torch.cuda.current_stream(messages.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    segment_spmm_tiles.launches += 1
    out = out.to(torch.float32)
    return out if messages.dim() == 3 else out[0]


segment_spmm_tiles.launches = 0


__all__ = ["segment_spmm_tiles", "segment_spmm_tiles_plain"]
