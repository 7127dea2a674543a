"""Tile-min kernels over the destination-tile edge layout, each beside its
plain PyTorch version.

``segment_min_tiles`` (K1) min-combines per-edge candidates into
[n_tiles, tile_v] output tiles — one window, or W windows in one launch.
``temporal_relax_min_tiles`` (K2) is a whole earliest-arrival round: the
window and ordering predicate, then the same per-tile min.  The CUDA
sources are ``csrc/temporal_edgemap.cu``.

Dispatch is by the tensors' device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  Each wrapper counts its
launches in ``<wrapper>.launches``.  The layout's ``block_tile`` must be
nondecreasing (a tile's blocks consecutive), as ``build_tile_layout``
emits it: the kernels finish a tile when its blocks end.  The wrappers
check that on the CPU, where it costs no device sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

INT_INF = 2**31 - 1
_MAX_SMEM = 48 * 1024   # static-launch dynamic shared memory limit
_MAX_GRID_Y = 65535
_CTA_SMEM = 224 * 1024  # of the 227 KB a Hopper CTA can have
_MAX_WINDOWS_PER_CTA = 32


def _check(name: str, device: torch.device, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_layout(name: str, dst_local, block_tile, n_tiles, tile_v, block_e):
    if block_tile.dim() != 1 or block_tile.shape[0] == 0:
        raise ValueError(f"{name}: block_tile must be a non-empty 1-D tensor")
    ep = block_tile.shape[0] * block_e
    if tuple(dst_local.shape) != (ep,):
        raise ValueError(
            f"{name}: dst_local has shape {tuple(dst_local.shape)}, expected ({ep},)")
    if n_tiles <= 0 or tile_v <= 0 or block_e <= 0:
        raise ValueError(f"{name}: n_tiles, tile_v and block_e must be positive")
    if tile_v * 4 > _MAX_SMEM:
        raise ValueError(f"{name}: tile_v={tile_v} exceeds the shared-memory tile")
    return ep


def _device_for(name: str, t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{name}: unsupported device {t.device}")


def _check_ordered(name: str, block_tile) -> None:
    if bool((block_tile[1:] < block_tile[:-1]).any()):
        raise ValueError(f"{name}: block_tile must be nondecreasing (a tile's "
                         f"blocks consecutive, as build_tile_layout emits them)")


def _tile_starts(block_tile, n_tiles: int):
    # imported here: ops imports this module
    from repro_torch.kernels.ops import tile_starts

    return tile_starts(block_tile, n_tiles)


def windows_per_cta(n_windows: int, tile_v: int) -> int:
    """Windows one K1 CTA min-combines together, one tile_v accumulator
    each in shared memory: W cut into equal chunks (one per grid row) of at
    most 32 windows and of what 224 KB hold."""
    most = min(_MAX_WINDOWS_PER_CTA, _CTA_SMEM // (4 * tile_v))
    n_chunks = -(-n_windows // most)
    return -(-n_windows // n_chunks)


def _flush_buffers(n_windows: int, n_chunks: int, n_tiles: int, tile_v: int, device):
    """The kernels' zeroed scratch tiles and per-(chunk, tile) counters,
    left at zero by every launch; K1 and K2 share them."""
    scratch = build.stream_zeros("tile_min", n_windows * n_tiles * tile_v, torch.int32,
                                 device)
    counter = build.stream_zeros("tile_min_count", n_chunks * n_tiles, torch.int32,
                                 device)
    return scratch, counter


# ---------------------------------------------------------------------------
# K1: segment_min_tiles
# ---------------------------------------------------------------------------

def segment_min_tiles_plain(dst_local, cand, block_tile, n_tiles: int, *,
                            tile_v: int = 512, block_e: int = 1024):
    """Plain version of K1: global slot ``tile * tile_v + dst_local``,
    out-of-range lanes masked to INF, then ``scatter_reduce_`` amin into an
    INF-filled buffer.  ``cand`` is [Ep] or [W, Ep]."""
    windowed = cand.dim() == 2
    c = cand.reshape(-1, cand.shape[-1])
    tile = block_tile.long().repeat_interleave(block_e)
    d = dst_local.long()
    ok = (d >= 0) & (d < tile_v) & (tile >= 0) & (tile < n_tiles)
    size = n_tiles * tile_v
    idx = torch.where(ok, tile * tile_v + d, 0)
    rows = torch.arange(c.shape[0], device=c.device)[:, None] * size
    vals = torch.where(ok[None, :], c, INT_INF)
    out = torch.full((c.shape[0] * size,), INT_INF, dtype=torch.int32,
                     device=c.device)
    out.scatter_reduce_(0, (idx[None, :] + rows).reshape(-1), vals.reshape(-1),
                        "amin", include_self=True)
    out = out.view(c.shape[0], n_tiles, tile_v)
    return out if windowed else out[0]


def segment_min_tiles(dst_local, cand, block_tile, n_tiles: int, *,
                      tile_v: int = 512, block_e: int = 1024):
    """K1: out[(W,) n_tiles, tile_v] per-tile minima of ``cand`` ([Ep] or
    [W, Ep], INF where masked) grouped by ``dst_local``; INF elsewhere."""
    name = "segment_min_tiles"
    ep = _check_layout(name, dst_local, block_tile, n_tiles, tile_v, block_e)
    _check(name, cand.device, dst_local=dst_local, cand=cand,
           block_tile=block_tile)
    if cand.dim() not in (1, 2) or cand.shape[-1] != ep:
        raise ValueError(f"{name}: cand has shape {tuple(cand.shape)}, expected "
                         f"({ep},) or (W, {ep})")
    if _device_for(name, cand) == "cpu":
        _check_ordered(name, block_tile)
        return segment_min_tiles_plain(dst_local, cand, block_tile, n_tiles,
                                       tile_v=tile_v, block_e=block_e)
    n_windows = cand.shape[0] if cand.dim() == 2 else 1
    if not 1 <= n_windows <= _MAX_GRID_Y:
        raise ValueError(f"{name}: {n_windows} windows, expected 1..{_MAX_GRID_Y}")
    wc = windows_per_cta(n_windows, tile_v)
    out = torch.empty((n_windows, n_tiles, tile_v), dtype=torch.int32,
                      device=cand.device)
    scratch, counter = _flush_buffers(n_windows, -(-n_windows // wc), n_tiles, tile_v,
                                      cand.device)
    lib = build.library("temporal_edgemap")
    rc = lib.segment_min_tiles_launch(
        dst_local.data_ptr(), cand.data_ptr(), block_tile.data_ptr(),
        _tile_starts(block_tile, n_tiles).data_ptr(), out.data_ptr(),
        scratch.data_ptr(), counter.data_ptr(), block_tile.shape[0],
        n_tiles, tile_v, block_e, n_windows, wc,
        torch.cuda.current_stream(cand.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    segment_min_tiles.launches += 1
    return out if cand.dim() == 2 else out[0]


segment_min_tiles.launches = 0


# ---------------------------------------------------------------------------
# K2: temporal_relax_min_tiles
# ---------------------------------------------------------------------------

def relax_candidates(arr_src, t_start, t_end, valid, window, strict: bool):
    """The earliest-arrival candidate per edge slot: ``t_end`` where the
    window and ordering predicate hold, INF elsewhere."""
    ta, tb = int(window[0]), int(window[1])
    follows = (arr_src < t_start) if strict else (arr_src <= t_start)
    ok = ((valid != 0) & (t_start >= ta) & (t_end <= tb) & follows
          & (arr_src < INT_INF))
    return torch.where(ok, t_end, INT_INF)


def temporal_relax_min_tiles_plain(dst_local, arr_src, t_start, t_end, valid,
                                   block_tile, window, n_tiles: int, *,
                                   tile_v: int = 512, block_e: int = 1024,
                                   strict: bool = False):
    """Plain version of K2: the candidate, then K1's plain version."""
    cand = relax_candidates(arr_src, t_start, t_end, valid, window, strict)
    return segment_min_tiles_plain(dst_local, cand, block_tile, n_tiles,
                                   tile_v=tile_v, block_e=block_e)


def temporal_relax_min_tiles(dst_local, arr_src, t_start, t_end, valid,
                             block_tile, window, n_tiles: int, *,
                             tile_v: int = 512, block_e: int = 1024,
                             strict: bool = False):
    """K2: out[n_tiles, tile_v] per-tile minima of the relaxed candidates.
    ``window`` is a host pair (ta, tb); it and ``strict`` reach the kernel
    as arguments."""
    name = "temporal_relax_min_tiles"
    ep = _check_layout(name, dst_local, block_tile, n_tiles, tile_v, block_e)
    _check(name, dst_local.device, dst_local=dst_local, arr_src=arr_src,
           t_start=t_start, t_end=t_end, valid=valid, block_tile=block_tile)
    for key, t in (("arr_src", arr_src), ("t_start", t_start),
                   ("t_end", t_end), ("valid", valid)):
        if tuple(t.shape) != (ep,):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected ({ep},)")
    ta, tb = int(window[0]), int(window[1])
    if _device_for(name, dst_local) == "cpu":
        _check_ordered(name, block_tile)
        return temporal_relax_min_tiles_plain(
            dst_local, arr_src, t_start, t_end, valid, block_tile, (ta, tb),
            n_tiles, tile_v=tile_v, block_e=block_e, strict=strict)
    out = torch.empty((n_tiles, tile_v), dtype=torch.int32, device=dst_local.device)
    scratch, counter = _flush_buffers(1, 1, n_tiles, tile_v, dst_local.device)
    lib = build.library("temporal_edgemap")
    rc = lib.temporal_relax_min_tiles_launch(
        dst_local.data_ptr(), arr_src.data_ptr(), t_start.data_ptr(),
        t_end.data_ptr(), valid.data_ptr(), block_tile.data_ptr(),
        _tile_starts(block_tile, n_tiles).data_ptr(), out.data_ptr(),
        scratch.data_ptr(), counter.data_ptr(), block_tile.shape[0],
        n_tiles, tile_v, block_e, ta, tb,
        int(bool(strict)), torch.cuda.current_stream(dst_local.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    temporal_relax_min_tiles.launches += 1
    return out


temporal_relax_min_tiles.launches = 0


__all__ = [
    "INT_INF",
    "segment_min_tiles",
    "segment_min_tiles_plain",
    "temporal_relax_min_tiles",
    "temporal_relax_min_tiles_plain",
    "relax_candidates",
    "windows_per_cta",
]
