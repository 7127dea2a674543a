"""Tiled segment-sum kernel (K3) over the destination-tile edge layout,
beside its plain PyTorch version.

``segment_spmm_tiles`` sums per-edge message rows into [n_tiles, tile_v, D]
output tiles, masked by ``valid`` — one window, or W windows in one launch.
The CUDA source is ``csrc/segment_spmm.cu``.  Kernel and plain version
both accumulate in float64 and round once to float32; the kernel adds a
tile shared by several CTAs with atomics in no fixed order, so
bit-reproducibility is not guaranteed.  The layout's ``block_tile`` must be
nondecreasing (a tile's blocks consecutive), as ``build_tile_layout``
emits it; the wrapper checks that on the CPU, where it costs no device
sync.

Dispatch is by the tensors' device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  The wrapper counts its launches
in ``segment_spmm_tiles.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.temporal_edgemap import _MAX_SMEM, _check, _check_layout, _device_for

_SMEM_SLOTS = _MAX_SMEM // 8   # float64 accumulator slots of a CTA


def flush_scratch_sizes(n_windows: int, n_tiles: int, tile_v: int, d: int):
    """Elements of the kernel's float64 scratch and int32 counters: a
    float64 copy of the output, and a counter per (window, feature chunk,
    tile); a feature chunk is as many columns as fit 48 KB at tile_v."""
    chunk = min(d, _SMEM_SLOTS // tile_v)
    return n_windows * n_tiles * tile_v * d, n_windows * -(-d // chunk) * n_tiles


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
    if tile_v > _SMEM_SLOTS:
        raise ValueError(f"{name}: tile_v={tile_v} exceeds the float64 shared tile")
    if _device_for(name, messages) == "cpu":
        if bool((block_tile[1:] < block_tile[:-1]).any()):
            raise ValueError(f"{name}: block_tile must be nondecreasing (a tile's "
                             f"blocks consecutive, as build_tile_layout emits them)")
        return segment_spmm_tiles_plain(dst_local, messages, valid, block_tile,
                                        n_tiles, tile_v=tile_v, block_e=block_e)
    n_windows = messages.shape[0] if messages.dim() == 3 else 1
    d = messages.shape[-1]
    out = torch.empty((n_windows, n_tiles, tile_v, d), dtype=torch.float32,
                      device=messages.device)
    # the shared tiles' float64 sums and per-tile counts, left at 0 by the kernel
    n_scratch, n_counter = flush_scratch_sizes(n_windows, n_tiles, tile_v, d)
    scratch = build.stream_zeros("segment_spmm", n_scratch, torch.float64, messages.device)
    counter = build.stream_zeros("segment_spmm_count", n_counter, torch.int32,
                                 messages.device)
    lib = build.library("segment_spmm")
    rc = lib.segment_spmm_tiles_launch(
        dst_local.data_ptr(), messages.data_ptr(), valid.data_ptr(),
        block_tile.data_ptr(), out.data_ptr(), scratch.data_ptr(), counter.data_ptr(),
        block_tile.shape[0], n_tiles, tile_v, block_e, d, n_windows,
        torch.cuda.current_stream(messages.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    segment_spmm_tiles.launches += 1
    return out if messages.dim() == 3 else out[0]


segment_spmm_tiles.launches = 0


__all__ = ["segment_spmm_tiles", "segment_spmm_tiles_plain", "flush_scratch_sizes"]
