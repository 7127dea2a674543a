"""Shared layers of the language model, plain functions on tensors (the
port of ``repro/models/layers.py``).

``swiglu`` keeps the reference's ``constrain`` of its hidden activation
(the identity without a mesh).  ``flash_attention`` is plain
``jnp`` in the reference and plain PyTorch here, with the same chunking.
``decode_attention`` goes through the flash-decode kernel K4
(``kernels/decode_attention.py``) on the card and its plain version on the
CPU.
``dense_init`` draws from a ``torch.Generator`` where the reference takes a
PRNG key; the two give different numbers from one seed.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import axis0_local, constrain, is_dtensor, replicated
from repro_torch.kernels import decode_attention as _k4


def dense_init(generator: torch.Generator, shape, axes, scale: Optional[float] = None,
               dtype=torch.float32):
    """(normal(shape) * scale, axes) on the generator's device; the scale is
    1/sqrt(shape[0]) by default (the reference's fan-in rule here)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)
    return t * scale, tuple(axes)


def rms_norm(x, gamma, eps: float = 1e-6):
    """Normalised in float32, rounded to x's dtype, then scaled by gamma."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma


def rope_tables(positions, d_head: int, theta: float = 1e4):
    """(cos, sin), each [..., S, 1, d_head // 2], of ``positions`` [..., S]:
    frequencies and angles in float32.  One pair serves every layer and
    both q and k at these positions."""
    half = d_head // 2
    dev = positions.device
    exponent = -torch.arange(half, dtype=torch.float32, device=dev) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=dev), exponent)
    angles = positions.to(torch.float32)[..., None] * freqs  # [..., S, half]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x, cos, sin):
    """x: [..., S, H, Dh] rotated by ``rope_tables``; result in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """x: [..., S, H, Dh]; positions: [..., S] (int)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 1024):
    """Online-softmax attention over (q chunk, kv chunk) tiles, as the
    reference computes it: scores and (m, l, acc) in float32, ``p`` rounded
    to v's dtype for the PV product.

    q: [B, S, H, Dh]; k, v: [B, S, KH, Dh] (GQA: H = KH * G).  S must be a
    multiple of ``min(q_chunk, S)`` and of ``min(kv_chunk, S)``; the
    reference's reshape raises otherwise, and so does this.
    """
    if is_dtensor(q):
        # DTensor: each rank attends its own batch rows, heads and sequence
        # whole (the chunks' einsums flatten sharded dimensions, which
        # DTensor's view rules refuse, and the causal mask needs the whole
        # sequence's positions)
        return axis0_local(lambda *t: flash_attention(
            *t, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk), 1, q, k, v)
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, S)
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"flash_attention: sequence length {S} is not a multiple of "
                         f"q_chunk {q_chunk} and kv_chunk {kv_chunk}")
    nq, nk = S // q_chunk, S // kv_chunk
    scale = 1.0 / math.sqrt(Dh)

    qr = q.reshape(B, nq, q_chunk, KH, G, Dh)
    kr = k.reshape(B, nk, kv_chunk, KH, Dh).float()
    vr = v.reshape(B, nk, kv_chunk, KH, Dh)
    blocks = []
    for qi in range(nq):
        qb = (qr[:, qi] * scale).float()  # [B, qc, KH, G, Dh]
        iq = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, KH, G, q_chunk), -torch.inf, device=q.device)
        l = torch.zeros((B, KH, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KH, G, q_chunk, Dh), device=q.device)
        for ki in range(nk):
            vb = vr[:, ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kr[:, ki])
            if causal:
                ik = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
                mask = iq[:, None] >= ik[None, :]
                s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        blocks.append(acc / l.clamp(min=1e-30)[..., None])  # [B, KH, G, qc, Dh]
    out = torch.stack(blocks, dim=1)                        # [B, nq, KH, G, qc, Dh]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, Dh)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token attention over a KV cache: q [B, H, Dh], caches
    [B, Smax, KH, Dh], ``cache_len`` a scalar or [B] — the number of valid
    positions per row.  Runs K4 on the card, its plain version on the CPU."""
    B = q.shape[0]
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=q.device)
    lens = lens.reshape(-1).expand(B).contiguous()
    return _k4.decode_attention(q, k_cache, v_cache, lens)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    h = constrain(h, "batch", "seq", "mlp") if h.ndim == 3 else h
    return h @ w_down


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in float32 (logsumexp); with ``mask``, the
    masked mean over max(sum(mask), 1).  logits [..., V], labels [...]."""
    # DTensor: the vocabulary is made whole first (a gather over
    # vocab-sharded logits takes the masked-partial path, which fails for
    # logits of more than two dimensions)
    logits = replicated(logits.float(), -1)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


__all__ = ["dense_init", "rms_norm", "rope", "rope_tables", "apply_rope", "flash_attention",
           "decode_attention", "swiglu", "softmax_cross_entropy"]
