"""Decoder-only transformer LM, dense or MoE (the port of
``repro/models/transformer.py``).

``LM`` is an ``nn.Module`` that holds the reference's parameter tree as it
is: ``model.params`` is a nested dict with ``embed``, ``final_ln``, unless
tied ``lm_head``, and ``layers``, whose leaves are STACKED ``[L, ...]``
(``wq wk wv wo ln1 ln2``, ``q_norm`` / ``k_norm``, and ``w_gate w_up
w_down`` or ``moe``: ``router w_gate w_up w_down`` and ``shared``), in the
reference's layouts (``wq`` is [L, d, H, Dh]).  Each leaf is an
``nn.Parameter`` that takes gradients.  ``model.layers[i]`` reads layer i's
weights as views (``blk.wq`` is ``params["layers"]["wq"][i]``; a pass over
``model.layers`` unbinds each leaf once).  So the
optimizer, gradient compression and checkpoints see the reference's leaves,
and any statistic they take over a whole leaf (Adafactor's update clip and
its factoring test, int8's absmax, top-k's threshold) spans every layer as
in the reference.

``forward``, ``loss_fn``, ``prefill``, ``init_cache`` and ``decode_step``
are plain functions that take the module, as the reference's take the
params.  ``init_lm`` draws random weights from a ``torch.Generator`` on the
device it is given (the first CUDA card unless named), which must be the
generator's; ``params_from_numpy`` carries the reference's params over and
``params_to_numpy`` gives them back.

Differences from the reference, each deliberate:
- Layers run as a Python loop over the blocks.  ``remat`` and ``unroll``
  select JAX mechanisms (rematerialisation, scan versus unrolled tracing)
  and are not fields here.  ``gather_weights`` is always on: each block's
  weights go through ``gather_fsdp`` at use time, the identity with no mesh.
- ``prefill`` and ``decode_step`` run under ``torch.inference_mode()``:
  serving builds no autograd graph.
- ``decode_step`` writes the new K/V into the cache tensors in place and
  returns the same dict; the reference returns fresh arrays.  A cache
  passed to ``decode_step`` must not be reused for another step from the
  same state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import constrain, gather_fsdp
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    flash_attention,
    rms_norm,
    rope_tables,
    softmax_cross_entropy,
    swiglu,
)
from repro_torch.models.moe import MoEConfig, moe_ffn
from repro_torch.tree import tree_items, tree_map


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
    moe: Optional[MoEConfig] = None
    rope_theta: float = 1e6
    use_qk_norm: bool = False
    dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 512
    kv_chunk: int = 1024
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def _attn_params(self) -> int:
        d, dh = self.d_model, self.head_dim
        return d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d

    def _embed_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tie_embeddings else 2)

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6ND model-flops accounting)."""
        d = self.d_model
        if self.moe:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
            ff += self.moe.n_shared * 3 * d * self.moe.d_ff
        else:
            ff = 3 * d * self.d_ff
        return self.n_layers * (self._attn_params() + ff + 2 * d) + self._embed_params() + d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params
        d = self.d_model
        ff = (self.moe.top_k + self.moe.n_shared) * 3 * d * self.moe.d_ff
        ff += d * self.moe.n_experts  # router
        return self.n_layers * (self._attn_params() + ff + 2 * d) + self._embed_params() + d


# ---------------------------------------------------------------------------
# layout and init
# ---------------------------------------------------------------------------

def _layout(cfg: LMConfig) -> Dict[str, Any]:
    """(shape, logical axes, init kind) of every parameter, in the
    reference's tree (``_layout``)."""
    d, dh, H, KH, L = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layer: Dict[str, Any] = {
        "wq": ((L, d, H, dh), ("layers", "fsdp", "heads", None), "dense"),
        "wk": ((L, d, KH, dh), ("layers", "fsdp", "kv_heads", None), "dense"),
        "wv": ((L, d, KH, dh), ("layers", "fsdp", "kv_heads", None), "dense"),
        "wo": ((L, H, dh, d), ("layers", "heads", None, "fsdp"), "dense"),
        "ln1": ((L, d), ("layers", None), "ones"),
        "ln2": ((L, d), ("layers", None), "ones"),
    }
    if cfg.use_qk_norm:
        layer["q_norm"] = ((L, dh), ("layers", None), "ones")
        layer["k_norm"] = ((L, dh), ("layers", None), "ones")
    if cfg.moe:
        E, F = cfg.moe.n_experts, cfg.moe.d_ff
        moe: Dict[str, Any] = {
            "router": ((L, d, E), ("layers", None, None), "dense"),
            "w_gate": ((L, E, d, F), ("layers", "experts", "fsdp", None), "dense"),
            "w_up": ((L, E, d, F), ("layers", "experts", "fsdp", None), "dense"),
            "w_down": ((L, E, F, d), ("layers", "experts", None, "fsdp"), "dense"),
        }
        if cfg.moe.n_shared:
            Fs = F * cfg.moe.n_shared
            moe["shared"] = {
                "w_gate": ((L, d, Fs), ("layers", "fsdp", "mlp"), "dense"),
                "w_up": ((L, d, Fs), ("layers", "fsdp", "mlp"), "dense"),
                "w_down": ((L, Fs, d), ("layers", "mlp", "fsdp"), "dense"),
            }
        layer["moe"] = moe
    else:
        layer["w_gate"] = ((L, d, cfg.d_ff), ("layers", "fsdp", "mlp"), "dense")
        layer["w_up"] = ((L, d, cfg.d_ff), ("layers", "fsdp", "mlp"), "dense")
        layer["w_down"] = ((L, cfg.d_ff, d), ("layers", "mlp", "fsdp"), "dense")
    tree: Dict[str, Any] = {
        "embed": ((cfg.vocab, d), ("vocab", None), "embed"),
        "layers": layer,
        "final_ln": ((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, cfg.vocab), ("fsdp", "vocab"), "dense")
    return tree


def param_shapes(cfg: LMConfig):
    """The parameter tree's shapes (tuples), allocating nothing."""
    return tree_map(lambda leaf: leaf[0], _layout(cfg))


def param_axes(cfg: LMConfig):
    """The parameter tree's logical-axis tuples."""
    return tree_map(lambda leaf: leaf[1], _layout(cfg))


def _draw(shape, kind, cfg: LMConfig, generator, device) -> torch.Tensor:
    """The reference's rule (``init_params``): ones, a unit normal for the
    embedding, and a normal over sqrt(shape[-2]) for every dense weight — the
    last-but-one axis of the stacked shape (H for ``wq``, not d), drawn in
    float32 and rounded to the model's dtype."""
    if kind == "ones":
        return torch.ones(shape, dtype=cfg.dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(generator=generator)
    if kind == "dense":
        t /= math.sqrt(1.0 * (shape[-2] if len(shape) >= 2 else 1))
    return t.to(cfg.dtype)


def _parameters(tree, layout, where: str = ""):
    """``tree`` as parameters that take gradients, each leaf checked against
    the layout's shape."""
    if isinstance(layout, dict):
        missing = sorted(set(layout) - set(tree))
        if missing:
            raise ValueError(f"{where or 'params'}: missing {missing}")
        return {k: _parameters(tree[k], v, f"{where}{k}/") for k, v in layout.items()}
    shape = layout[0]
    if tuple(tree.shape) != shape:
        raise ValueError(f"{where[:-1]}: shape {tuple(tree.shape)}, expected {shape}")
    return nn.Parameter(tree.detach(), requires_grad=True)


class Block:
    """Layer ``index``'s weights under the reference's per-layer names, each
    a view of the stacked parameter (``blk.moe`` a dict of views)."""

    def __init__(self, index: int, weights: Dict[str, Any]):
        self.index = index
        self.__dict__.update(weights)


# use-time logical axes of each per-layer weight (the leading "layers" dim
# already unbound), consumed by the ZeRO-3 gather below
_WEIGHT_AXES = {
    "wq": ("fsdp", "heads", None),
    "wk": ("fsdp", "kv_heads", None),
    "wv": ("fsdp", "kv_heads", None),
    "wo": ("heads", None, "fsdp"),
    "w_gate": ("fsdp", "mlp"),
    "w_up": ("fsdp", "mlp"),
    "w_down": ("mlp", "fsdp"),
}
_MOE_WEIGHT_AXES = {
    "w_gate": ("experts", "fsdp", None),
    "w_up": ("experts", "fsdp", None),
    "w_down": ("experts", None, "fsdp"),
}


def _gather_layer_weights(blk: Block) -> Block:
    """The reference's per-layer ZeRO-3 all-gather of the fsdp-sharded
    weights; with no mesh every weight is returned as it is."""
    w = dict(blk.__dict__)
    for k, ax in _WEIGHT_AXES.items():
        if k in w:
            w[k] = gather_fsdp(w[k], *ax)
    if "moe" in w:
        moe = dict(w["moe"])
        for k, ax in _MOE_WEIGHT_AXES.items():
            moe[k] = gather_fsdp(moe[k], *ax)
        if "shared" in moe:
            moe["shared"] = {k: gather_fsdp(v, *_WEIGHT_AXES[k])
                             for k, v in moe["shared"].items()}
        w["moe"] = moe
    return Block(w.pop("index"), w)


def _blocks(layers: Dict[str, Any], n_layers: int):
    """Every layer's ``Block``: one ``unbind`` per stacked leaf, so a pass
    over the layers makes one view op (and, under autograd, one backward
    node) per leaf rather than one per leaf and layer."""
    per_leaf = tree_map(lambda p: torch.unbind(p, 0), layers)
    return [Block(i, tree_map(lambda views, i=i: views[i], per_leaf)) for i in range(n_layers)]


class LM(nn.Module):
    """A decoder-only LM's parameters: ``params`` is the reference's tree of
    stacked leaves; ``layers`` the per-layer views (made anew at each
    access).  ``init_lm`` draws them, ``params_from_numpy`` carries the
    reference's over."""

    def __init__(self, cfg: LMConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = _parameters(params, _layout(cfg))
        for path, p in tree_items(self.params):
            self.register_parameter(path.replace("/", "__"), p)

    @property
    def layers(self):
        return _blocks(self.params["layers"], self.cfg.n_layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: LMConfig, generator: torch.Generator, device=None) -> LM:
    """Random weights drawn from ``generator``, on ``device`` (the first
    CUDA card unless given); the generator must be on that device."""
    device = resolve_device(device)
    gdev = generator.device
    if gdev.type != device.type or device.index not in (None, gdev.index):
        raise ValueError(f"init_lm: the generator is on {gdev}, the weights go to {device}")
    with torch.no_grad():
        params = tree_map(lambda leaf: _draw(leaf[0], leaf[2], cfg, generator, device),
                          _layout(cfg))
    return LM(cfg, params)


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
    return LM(cfg, tree_map(lambda _, a: _as_tensor(a, device), _layout(cfg), tree))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            raise TypeError("a bfloat16 leaf needs ml_dtypes to become a numpy array") \
                from None
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(model: LM) -> Dict:
    """The inverse of ``params_from_numpy``: the reference's stacked tree as
    numpy arrays (bfloat16 leaves as ml_dtypes' bfloat16)."""
    return tree_map(_to_numpy, model.params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _proj(x, w):
    """x [..., d] @ w [d, ...] -> [..., *w.shape[1:]] (the reference's
    ``einsum("...d,dhk->...hk")``)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[:-1] + w.shape[1:])


def _ffn(cfg: LMConfig, blk, x):
    """The block's FFN over x [..., d]: (out, MoE auxiliary loss; 0 when dense)."""
    dt = x.dtype
    if cfg.moe:
        flat, aux = moe_ffn(blk.moe, x.reshape(-1, x.shape[-1]), cfg.moe)
        return flat.reshape(x.shape), aux
    out = swiglu(x, blk.w_gate.to(dt), blk.w_up.to(dt), blk.w_down.to(dt))
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


def layer_forward(cfg: LMConfig, blk, h, rot):
    """One block over a whole sequence: h [B, S, d] -> (h, k, v, aux);
    ``rot`` is the sequence's ``rope_tables``."""
    B, S, _ = h.shape
    blk = _gather_layer_weights(blk)
    x = rms_norm(h, blk.ln1)
    q = _proj(x, blk.wq.to(x.dtype))
    k = _proj(x, blk.wk.to(x.dtype))
    v = _proj(x, blk.wv.to(x.dtype))
    if cfg.use_qk_norm:
        q = rms_norm(q, blk.q_norm)
        k = rms_norm(k, blk.k_norm)
    q = apply_rope(q, *rot)
    k = apply_rope(k, *rot)
    q = constrain(q, "batch", "seq", "heads", None)
    # under sequence-parallel rules ("seq" -> model), K/V gather the full
    # sequence (the SP all-gather); under TP rules this is a no-op
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    attn = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                           kv_chunk=cfg.kv_chunk)
    h = h + attn.reshape(B, S, -1) @ blk.wo.to(x.dtype).reshape(-1, cfg.d_model)
    ff, aux = _ffn(cfg, blk, rms_norm(h, blk.ln2))
    return constrain(h + ff, "batch", "seq", None), k, v, aux


def _head(model: LM):
    """The output projection [d, vocab]: the embedding's transpose when tied,
    else ``lm_head`` (ZeRO-3 gathered)."""
    if model.cfg.tie_embeddings:
        return model.embed.T
    return gather_fsdp(model.lm_head, "fsdp", "vocab")


def _logits(model: LM, h, *axes):
    """Final norm and head; ``axes``, when given, are the logits' logical
    axes."""
    h = rms_norm(h, model.final_ln)
    logits = h @ _head(model).to(h.dtype)
    return (constrain(logits, *axes) if axes else logits).to(torch.float32)


def forward(model: LM, tokens):
    """tokens [B, S] -> (logits [B, S, vocab] float32, summed MoE aux loss)."""
    cfg = model.cfg
    B, S = tokens.shape
    h = constrain(model.embed[tokens].to(cfg.dtype), "batch", "seq", None)
    rot = rope_tables(torch.arange(S, device=h.device).expand(B, S), cfg.head_dim,
                      cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for blk in model.layers:
        h, _, _, a = layer_forward(cfg, blk, h, rot)
        aux = aux + a
    return _logits(model, h, "batch", "seq", "vocab"), aux


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], aux_weight: float = 0.01):
    """Cross-entropy of ``batch["labels"]`` (masked by ``batch["mask"]``
    when present) plus ``aux_weight`` x the MoE auxiliary loss; returns
    (loss, {"ce", "aux"})."""
    logits, aux = forward(model, batch["tokens"])
    ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


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
    tokens' ``rope_tables``.  A MoE block dispatches the B tokens as one
    batch, so its capacity follows B."""
    rows, cache_len, attend = slot
    B = h.shape[0]
    blk = _gather_layer_weights(blk)
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
    return h + _ffn(cfg, blk, rms_norm(h, blk.ln2))[0]


@torch.inference_mode()
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
    return _logits(model, h, "batch", "vocab"), cache


@torch.inference_mode()
def prefill(model: LM, tokens, max_seq: Optional[int] = None):
    """Forward over the prompt, materialising the KV cache.

    Returns (last_logits [B, vocab], cache) with the cache in
    ``decode_step``'s layout ([L, B, max_seq, KH, Dh], zero past the prompt).
    """
    cfg = model.cfg
    B, S = tokens.shape
    max_seq = max_seq or S
    h = constrain(model.embed[tokens].to(cfg.dtype), "batch", "seq", None)
    rot = rope_tables(torch.arange(S, device=h.device).expand(B, S), cfg.head_dim,
                      cfg.rope_theta)
    cache = init_cache(cfg, B, max_seq, device=h.device)
    for i, blk in enumerate(model.layers):
        h, k, v, _ = layer_forward(cfg, blk, h, rot)
        # the cache keeps the decode layout (kv_seq over model)
        cache["k"][i, :, :S] = constrain(k, "batch", "kv_seq", "kv_heads", None)
        cache["v"][i, :, :S] = constrain(v, "batch", "kv_seq", "kv_heads", None)
    return _logits(model, h[:, -1]), cache


__all__ = ["LMConfig", "MoEConfig", "LM", "init_lm", "params_from_numpy", "params_to_numpy",
           "param_shapes", "param_axes", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill", "layer_forward", "layer_decode"]
