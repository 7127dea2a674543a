"""Decoder-only transformer LM, dense (the port of
``repro/models/transformer.py`` for serving).

``LM`` is an ``nn.Module`` whose blocks hold the reference's per-layer
weights under the reference's names (``wq wk wv wo ln1 ln2 w_gate w_up
w_down``, plus ``q_norm`` / ``k_norm``; ``embed``, ``final_ln`` and, unless
tied, ``lm_head`` on the model), in the reference's layouts: ``wq`` is
[d, H, Dh], ``wo`` [H, Dh, d].  ``forward``, ``prefill``, ``init_cache`` and
``decode_step`` are plain functions that take the module, as the
reference's take the params.  ``init_lm`` draws random weights from a
``torch.Generator`` on the device it is given (the first CUDA card
unless named), which must be the generator's; ``params_from_numpy``
carries the reference's params (stacked ``[L, ...]``) over.

Differences from the reference, each deliberate:
- Layers run as a Python loop over the blocks.  ``remat``, ``unroll`` and
  ``gather_weights`` select JAX mechanisms (rematerialisation, scan versus
  unrolled tracing, ZeRO-3 gathers) and are not fields here; MoE layers
  (``moe``) are not ported yet, so ``forward`` returns the logits alone,
  without the MoE auxiliary loss.
- The weights are made without gradients: this is the serving path.
- ``decode_step`` writes the new K/V into the cache tensors in place and
  returns the same dict; the reference returns fresh arrays.  A cache
  passed to ``decode_step`` must not be reused for another step from the
  same state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    flash_attention,
    rms_norm,
    rope_tables,
    swiglu,
)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    rope_theta: float = 1e6
    use_qk_norm: bool = False
    dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 512
    kv_chunk: int = 1024
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6ND model-flops accounting)."""
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d
        ff = 3 * d * self.d_ff
        norms = 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff + norms) + emb + d


def _block_layout(cfg: LMConfig) -> Dict[str, tuple]:
    """(per-layer shape, init kind) of each weight of one block."""
    d, dh, H, KH = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    layout = {
        "wq": ((d, H, dh), "dense"),
        "wk": ((d, KH, dh), "dense"),
        "wv": ((d, KH, dh), "dense"),
        "wo": ((H, dh, d), "dense"),
        "ln1": ((d,), "ones"),
        "ln2": ((d,), "ones"),
    }
    if cfg.use_qk_norm:
        layout["q_norm"] = ((dh,), "ones")
        layout["k_norm"] = ((dh,), "ones")
    layout["w_gate"] = ((d, cfg.d_ff), "dense")
    layout["w_up"] = ((d, cfg.d_ff), "dense")
    layout["w_down"] = ((cfg.d_ff, d), "dense")
    return layout


def _model_layout(cfg: LMConfig) -> Dict[str, tuple]:
    layout = {"embed": ((cfg.vocab, cfg.d_model), "embed"),
              "final_ln": ((cfg.d_model,), "ones")}
    if not cfg.tie_embeddings:
        layout["lm_head"] = ((cfg.d_model, cfg.vocab), "dense")
    return layout


def _draw(shape, kind, cfg: LMConfig, generator, device) -> torch.Tensor:
    """The reference's rule (``init_params``): ones, a unit normal for the
    embedding, and a normal over sqrt(shape[-2]) for every dense weight — the
    last-but-one axis of the weight's shape (H for ``wq``, not d), drawn in
    float32 and rounded to the model's dtype."""
    if kind == "ones":
        return torch.ones(shape, dtype=cfg.dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(generator=generator)
    if kind == "dense":
        t /= math.sqrt(1.0 * (shape[-2] if len(shape) >= 2 else 1))
    return t.to(cfg.dtype)


def _params(weights: Dict[str, torch.Tensor], layout: Dict[str, tuple], where: str):
    """The weights as frozen parameters, each checked against its shape."""
    out = {}
    for name, (shape, _) in layout.items():
        t = weights[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{where}{name}: shape {tuple(t.shape)}, expected {shape}")
        out[name] = nn.Parameter(t, requires_grad=False)
    return out


class Block(nn.Module):
    def __init__(self, cfg: LMConfig, weights: Dict[str, torch.Tensor], where: str = ""):
        super().__init__()
        for name, p in _params(weights, _block_layout(cfg), where).items():
            setattr(self, name, p)


class LM(nn.Module):
    """The weights of a dense decoder-only LM: ``weights`` holds the model's
    own (``embed``, ``final_ln``, ``lm_head``), ``blocks`` one dict per
    layer.  ``init_lm`` draws them, ``params_from_numpy`` carries the
    reference's over."""

    def __init__(self, cfg: LMConfig, weights: Dict[str, torch.Tensor], blocks):
        super().__init__()
        self.cfg = cfg
        for name, p in _params(weights, _model_layout(cfg), "").items():
            setattr(self, name, p)
        self.layers = nn.ModuleList(Block(cfg, b, f"layers[{i}].")
                                    for i, b in enumerate(blocks))
        if len(self.layers) != cfg.n_layers:
            raise ValueError(f"{len(self.layers)} blocks for {cfg.n_layers} layers")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_lm(cfg: LMConfig, generator: torch.Generator, device=None) -> LM:
    """Random weights drawn from ``generator``, on ``device`` (the first
    CUDA card unless given); the generator must be on that device."""
    device = resolve_device(device)
    gdev = generator.device
    if gdev.type != device.type or device.index not in (None, gdev.index):
        raise ValueError(f"init_lm: the generator is on {gdev}, the weights go to {device}")
    weights = {name: _draw(shape, kind, cfg, generator, device)
               for name, (shape, kind) in _model_layout(cfg).items()}
    blocks = [{name: _draw(shape, kind, cfg, generator, device)
               for name, (shape, kind) in _block_layout(cfg).items()}
              for _ in range(cfg.n_layers)]
    return LM(cfg, weights, blocks)


def _as_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (ml_dtypes, which
    ``torch.from_numpy`` does not take) goes through its 16 bits."""
    a = np.array(a)  # a writable copy (the reference's arrays are read-only)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict, cfg: LMConfig, device=None) -> LM:
    """The reference's params as a nested dict of numpy arrays (``layers``
    stacked [L, ...], as ``init_params`` returns them) as the port's ``LM``,
    on ``device`` (the first CUDA card unless given)."""
    device = resolve_device(device)
    weights = {name: _as_tensor(tree[name], device) for name in _model_layout(cfg)}
    blocks = [{name: _as_tensor(tree["layers"][name][i], device)
               for name in _block_layout(cfg)}
              for i in range(cfg.n_layers)]
    return LM(cfg, weights, blocks)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _proj(x, w):
    """x [..., d] @ w [d, ...] -> [..., *w.shape[1:]] (the reference's
    ``einsum("...d,dhk->...hk")``)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[:-1] + w.shape[1:])


def _ffn(blk, x):
    dt = x.dtype
    return swiglu(x, blk.w_gate.to(dt), blk.w_up.to(dt), blk.w_down.to(dt))


def layer_forward(cfg: LMConfig, blk, h, rot):
    """One block over a whole sequence: h [B, S, d] -> (h, k, v); ``rot``
    is the sequence's ``rope_tables``."""
    B, S, _ = h.shape
    x = rms_norm(h, blk.ln1)
    q = _proj(x, blk.wq.to(x.dtype))
    k = _proj(x, blk.wk.to(x.dtype))
    v = _proj(x, blk.wv.to(x.dtype))
    if cfg.use_qk_norm:
        q = rms_norm(q, blk.q_norm)
        k = rms_norm(k, blk.k_norm)
    q = apply_rope(q, *rot)
    k = apply_rope(k, *rot)
    attn = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                           kv_chunk=cfg.kv_chunk)
    h = h + attn.reshape(B, S, -1) @ blk.wo.to(x.dtype).reshape(-1, cfg.d_model)
    h = h + _ffn(blk, rms_norm(h, blk.ln2))
    return h, k, v


def _logits(model: LM, h):
    h = rms_norm(h, model.final_ln)
    return (h @ model.head().to(h.dtype)).to(torch.float32)


def forward(model: LM, tokens):
    """tokens [B, S] -> logits [B, S, vocab] (float32)."""
    cfg = model.cfg
    B, S = tokens.shape
    h = model.embed[tokens].to(cfg.dtype)
    rot = rope_tables(torch.arange(S, device=h.device).expand(B, S), cfg.head_dim,
                      cfg.rope_theta)
    for blk in model.layers:
        h, _, _ = layer_forward(cfg, blk, h, rot)
    return _logits(model, h)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None):
    """Zero K/V caches in the model's dtype, each [L, batch, max_seq, KH, Dh],
    on ``device`` (the first CUDA card unless given)."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def layer_decode(cfg: LMConfig, blk, h, kc, vc, slot, rot):
    """One block for one new token per row: h [B, d] -> h.  ``slot`` is
    (rows, cache_len, attend): the token's K/V are written at
    ``[rows, cache_len]`` of kc / vc ([B, S, KH, Dh]) in place, and each row
    attends over its first ``attend`` (int32) positions; ``rot`` is the
    tokens' ``rope_tables``."""
    rows, cache_len, attend = slot
    B = h.shape[0]
    x = rms_norm(h, blk.ln1)
    q = _proj(x, blk.wq.to(x.dtype))
    k = _proj(x, blk.wk.to(x.dtype))
    v = _proj(x, blk.wv.to(x.dtype))
    if cfg.use_qk_norm:
        q = rms_norm(q, blk.q_norm)
        k = rms_norm(k, blk.k_norm)
    q = apply_rope(q[:, None], *rot)[:, 0]
    k = apply_rope(k[:, None], *rot)[:, 0]
    kc[rows, cache_len] = k.to(kc.dtype)
    vc[rows, cache_len] = v.to(vc.dtype)
    attn = decode_attention(q, kc, vc, attend)
    h = h + attn.reshape(B, -1) @ blk.wo.to(x.dtype).reshape(-1, cfg.d_model)
    return h + _ffn(blk, rms_norm(h, blk.ln2))


def decode_step(model: LM, cache, tokens, cache_len):
    """One decode step with per-slot cache lengths (continuous batching).

    tokens [B]; cache_len: scalar or [B] — the number of valid positions
    per row.  Writes each row's new K/V at position ``cache_len`` of
    ``cache`` in place and returns (logits [B, vocab], cache).
    """
    cfg = model.cfg
    B = tokens.shape[0]
    dev = model.device
    cache_len = torch.as_tensor(cache_len, dtype=torch.int64, device=dev).reshape(-1)
    cache_len = cache_len.expand(B)
    slot = (torch.arange(B, device=dev), cache_len, (cache_len + 1).to(torch.int32))
    rot = rope_tables(cache_len[:, None], cfg.head_dim, cfg.rope_theta)  # positions [B, 1]
    h = model.embed[tokens].to(cfg.dtype)      # [B, d]
    for i, blk in enumerate(model.layers):
        h = layer_decode(cfg, blk, h, cache["k"][i], cache["v"][i], slot, rot)
    return _logits(model, h), cache


def prefill(model: LM, tokens, max_seq: Optional[int] = None):
    """Forward over the prompt, materialising the KV cache.

    Returns (last_logits [B, vocab], cache) with the cache in
    ``decode_step``'s layout ([L, B, max_seq, KH, Dh], zero past the prompt).
    """
    cfg = model.cfg
    B, S = tokens.shape
    max_seq = max_seq or S
    h = model.embed[tokens].to(cfg.dtype)
    rot = rope_tables(torch.arange(S, device=h.device).expand(B, S), cfg.head_dim,
                      cfg.rope_theta)
    cache = init_cache(cfg, B, max_seq, device=h.device)
    for i, blk in enumerate(model.layers):
        h, k, v = layer_forward(cfg, blk, h, rot)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _logits(model, h[:, -1]), cache


__all__ = ["LMConfig", "LM", "init_lm", "params_from_numpy", "forward", "init_cache",
           "decode_step", "prefill", "layer_forward", "layer_decode"]
