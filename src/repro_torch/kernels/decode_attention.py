"""Flash-decode attention kernel (K4) beside its plain PyTorch version.

``decode_attention`` attends one query token per row over a KV cache with
per-row lengths: q [B, H, Dh], k_cache / v_cache [B, S, KH, Dh],
cache_len int32 [B]; query head h reads KV head h // (H / KH).  Positions
at or past ``cache_len[b]`` take no part.  The CUDA source is
``csrc/decode_attention.cu``.

A row whose ``cache_len`` is 0 (or negative) attends to nothing, and both
versions return zeros for it: the ``max(l, 1e-30)`` guard of the
reference kernel intends that, although the Pallas kernel itself returns
the mean of the padded V block there and the reference's oracle NaN.  The
model never passes 0 (``decode_step`` attends over ``cache_len + 1``).

Dispatch is by the tensors' device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  The wrapper counts its
launches in ``decode_attention.launches``.  A meta tensor (the dry run's)
takes ``decode_attention_meta``, the plain version's shape path: it
computes nothing and launches nothing.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

# The kernel picks the positions per split from the lengths on the device,
# at least MIN_CHUNK and few enough for MAX_SPLIT splits per row (its
# kMinChunk, kMaxSplit, and kTile = 32 as the rounding); the partial-softmax
# scratch is sized for the most splits a row can have.
MIN_CHUNK = 64
MAX_SPLIT = 32
MAX_GROUP = 8           # the kernel is instantiated for G = 1..8
# the Pallas kernel's masking score, exported as the reference exports it;
# K4 and its plain version mask with -inf and give a row with no valid
# position zeros (see above)
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_scratch(B: int, S: int, KH: int, G: int, Dh: int):
    """Shape of the kernel's float32 partial-softmax scratch: (row, KV head,
    split, query head, (acc[Dh], m, l, 2 floats of padding))."""
    chunk = -(-max(MIN_CHUNK, -(-S // MAX_SPLIT)) // 32) * 32
    return (B, KH, -(-S // chunk), G, Dh + 4)


def decode_attention_plain(q, k_cache, v_cache, cache_len):
    """Plain version of K4, op for op the reference's
    ``models/layers.py::decode_attention`` with per-row lengths: the score
    ``(q * scale) . k`` in float32 (``q * scale`` rounded to q's dtype),
    masked softmax, then ``p`` rounded to the cache's dtype for the float32
    PV product.  A row with no valid position gives zeros."""
    B, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    qr = q.reshape(B, KH, G, Dh) * scale
    s = torch.einsum("bhgd,bshd->bhgs", qr.float(), k_cache.float())
    valid = torch.arange(S, device=q.device)[None, :] < cache_len.reshape(B, 1).long()
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, H, Dh).to(q.dtype)


def decode_attention_meta(q, k_cache, v_cache):
    """K4's result shape for meta tensors (the dry run): the plain version's
    two products, scores over every cache position and their weighted sum
    of V, in the cache's dtype, with no mask and no softmax.  A FLOP counter
    counts them as K4's 4·B·H·S·Dh; like the kernel they make no float32
    copy of the cache."""
    B, H, Dh = q.shape
    KH = k_cache.shape[2]
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, KH, H // KH, Dh), k_cache)
    out = torch.einsum("bhgs,bshd->bhgd", s, v_cache)
    return out.reshape(B, H, Dh).to(q.dtype)


def _check(q, k_cache, v_cache, cache_len):
    name = "decode_attention"
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, Dh] and the caches [B, S, KH, Dh], "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, H, Dh = q.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"{name}: v_cache has shape {tuple(v_cache.shape)}, "
                         f"k_cache {tuple(k_cache.shape)}")
    if k_cache.shape[0] != B or k_cache.shape[3] != Dh or k_cache.shape[1] < 1:
        raise ValueError(f"{name}: caches of shape {tuple(k_cache.shape)} do not fit q "
                         f"of shape {tuple(q.shape)}")
    KH = k_cache.shape[2]
    if KH < 1 or H % KH:
        raise ValueError(f"{name}: {H} query heads are not a multiple of {KH} KV heads")
    if tuple(cache_len.shape) != (B,) or cache_len.dtype != torch.int32:
        raise ValueError(f"{name}: cache_len must be int32 [{B}], got "
                         f"{cache_len.dtype} {tuple(cache_len.shape)}")
    for key, t in (("k_cache", k_cache), ("v_cache", v_cache), ("cache_len", cache_len)):
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {q.device}")
    for key, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, q is {q.dtype}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {q.device}")


def _vector_width(q, k_cache, v_cache) -> int:
    """Elements per load: 16 bytes when every row of q and of the caches
    starts 16-byte aligned, else one element."""
    Dh = q.shape[-1]
    vec = 16 // q.element_size()
    aligned = (Dh % vec == 0 and all(t.data_ptr() % 16 == 0
                                     for t in (q, k_cache, v_cache)))
    return vec if aligned else 1


def decode_attention(q, k_cache, v_cache, cache_len):
    """K4: o [B, H, Dh] = softmax(q k^T / sqrt(Dh)) v over each row's first
    ``cache_len[b]`` cache positions; float32 or bfloat16, o in q's dtype."""
    name = "decode_attention"
    _check(q, k_cache, v_cache, cache_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if q.device.type == "meta":
        return decode_attention_meta(q, k_cache, v_cache)
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {q.dtype}")
    for key, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                   ("cache_len", cache_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    B, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    if G > MAX_GROUP:
        raise ValueError(f"{name}: a GQA group of {G} exceeds the kernel's {MAX_GROUP}")
    vec = _vector_width(q, k_cache, v_cache)
    if Dh > 32 * vec:
        raise ValueError(f"{name}: d_head {Dh} exceeds the kernel's {32 * vec} "
                         f"for {q.dtype} rows of this alignment")
    shape = split_scratch(B, S, KH, G, Dh)
    part = torch.empty(shape, dtype=torch.float32, device=q.device)
    # per-(row, KV head) counts of finished splits, left at 0 by the kernel
    counter = build.stream_zeros("decode_attention", B * KH, torch.int32, q.device)
    out = torch.empty_like(q)
    lib = build.library("decode_attention")
    rc = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
        part.data_ptr(), counter.data_ptr(), out.data_ptr(), B, S, KH, G, Dh, shape[2],
        ctypes.c_float(1.0 / math.sqrt(Dh)), _DTYPES[q.dtype], vec,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


__all__ = ["decode_attention", "decode_attention_plain", "decode_attention_meta",
           "split_scratch", "MIN_CHUNK",
           "MAX_SPLIT", "MAX_GROUP"]
