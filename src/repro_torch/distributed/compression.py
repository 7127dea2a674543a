"""Gradient compression for the data-parallel all-reduce (the port of
``repro/distributed/compression.py``).

Two schemes, both with error feedback (the residual of the compression is
carried into the next step):

  * int8 quantization — per-leaf absmax scaling, 4x wire reduction;
  * top-k sparsification — keep the largest |g| entries of each leaf.

A leaf is a whole (stacked ``[L, ...]``) parameter of the tree, so the
absmax and the top-k threshold span every layer, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.distributed.sharding import replicated
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"          # none | int8 | topk
    topk_ratio: float = 0.01    # fraction of entries kept (topk)


def init_error_feedback(params):
    from repro_torch.train.optimizer import state_zeros

    return tree_map(state_zeros, params)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _compress_leaf_int8(g, err):
    g_fb = g.float() + err
    q, scale = quantize_int8(g_fb)
    g_hat = dequantize_int8(q, scale)
    return g_hat.to(g.dtype), g_fb - g_hat


def _compress_leaf_topk(g, err, ratio: float):
    g_fb = g.float() + err
    # DTensor: topk over a sharded leaf has no sharding rule; the threshold
    # is taken over the whole leaf on every rank
    flat = replicated(g_fb, *range(g_fb.ndim)).reshape(-1)
    k = max(int(flat.shape[0] * ratio), 1)
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    g_hat = torch.where(torch.abs(g_fb) >= thresh, g_fb, 0.0)
    return g_hat.to(g.dtype), g_fb - g_hat


def compress_gradients(grads, err_state, cfg: CompressionConfig):
    """Returns (compressed grads, new error-feedback state)."""
    if cfg.kind == "none":
        return grads, err_state
    if cfg.kind == "int8":
        fn = _compress_leaf_int8
    elif cfg.kind == "topk":
        fn = lambda g, e: _compress_leaf_topk(g, e, cfg.topk_ratio)
    else:
        raise ValueError(cfg.kind)
    with torch.no_grad():
        out = tree_map(fn, grads, err_state)
    pick = lambda i: tree_map(lambda _, o: o[i], grads, out)
    return pick(0), pick(1)


def wire_bytes(params, cfg: CompressionConfig) -> int:
    """Modelled all-reduce payload under the compression scheme."""
    n = sum(int(l.numel()) for l in tree_leaves(params))
    if cfg.kind == "int8":
        return n  # 1 byte each (+ negligible scales)
    if cfg.kind == "topk":
        return int(n * cfg.topk_ratio) * 8  # value + index
    return n * 2  # bf16 baseline


__all__ = ["CompressionConfig", "init_error_feedback", "quantize_int8", "dequantize_int8",
           "compress_gradients", "wire_bytes"]
