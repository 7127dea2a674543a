"""MIND (arXiv:1904.08030): Multi-Interest Network with Dynamic routing
(the port of ``repro/models/mind.py``).

Huge item-embedding table -> behavior-sequence EmbeddingBag (a gather +
mask) -> B2I capsule dynamic routing into K interest capsules (the
reference's ``lax.scan`` over ``capsule_iters`` is a Python loop) ->
label-aware attention (train) / max-over-interest scoring (retrieval).
Retrieval's top-k is a stable descending sort, so among equal scores the
lower candidate position comes first, as ``jax.lax.top_k`` orders them.

Not ported: ``mind_param_axes``, the logical sharding axes of the
parameters (sharded training is ROADMAP Queue 1 item 16b).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models.params import carry_params, draw_params


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str
    n_items: int
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0          # label-aware attention sharpness
    n_negatives: int = 1024     # sampled-softmax negatives (train)
    dtype: Any = torch.float32


def _layout(cfg: MINDConfig) -> Dict:
    """The reference's parameter tree with ``(shape, scale[, dtype])`` leaves."""
    d = cfg.embed_dim
    return {
        "item_embed": ((cfg.n_items, d), 0.02),
        "bilinear": ((d, d), 1.0 / math.sqrt(d)),
        "mlp_w1": ((d, 4 * d), 1.0 / math.sqrt(d)),
        "mlp_b1": ((4 * d,), None),
        "mlp_w2": ((4 * d, d), 1.0 / math.sqrt(4.0 * d)),
        "mlp_b2": ((d,), None),
        # fixed (untrained) routing-logit initializer, as in the paper
        "routing_init": ((cfg.n_interests, cfg.hist_len), 1.0, torch.float32),
    }


def init_mind(cfg: MINDConfig, generator: torch.Generator, device=None) -> Dict:
    return draw_params(_layout(cfg), cfg.dtype, generator, device)


def params_from_numpy(tree: Dict, cfg: MINDConfig, device=None) -> Dict:
    """The reference's ``init_mind`` tree as numpy arrays -> the port's."""
    return carry_params(_layout(cfg), tree, cfg.dtype, device)


def embedding_bag(table, ids, mask=None, combine: str = "none"):
    """EmbeddingBag: gather rows + optional masked reduce.
    ids [..., H] -> [..., H, d] ('none') or [..., d] ('sum'/'mean')."""
    out = F.embedding(ids, table)
    if mask is not None:
        out = out * mask[..., None].to(out.dtype)
    if combine == "sum":
        return out.sum(dim=-2)
    if combine == "mean":
        denom = (mask.sum(dim=-1, keepdim=True).to(out.dtype)
                 if mask is not None else out.new_tensor(float(out.shape[-2])))
        return out.sum(dim=-2) / torch.clamp(denom, min=1.0)
    return out


def _squash(x, dim=-1):
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def user_tower(params, hist_ids, cfg: MINDConfig):
    """hist_ids [B, H] (0 = padding) -> interests [B, K, d]."""
    mask = hist_ids > 0                                  # [B, H]
    e = embedding_bag(params["item_embed"], hist_ids, mask)  # [B, H, d]
    e = constrain(e, "batch", None, None)
    se = e @ params["bilinear"]                          # shared S transform

    B = hist_ids.shape[0]
    b = params["routing_init"][None].expand(B, cfg.n_interests, cfg.hist_len)
    neg = torch.tensor(-1e9, dtype=torch.float32, device=b.device)
    b = torch.where(mask[:, None, :], b, neg)
    for _ in range(cfg.capsule_iters):
        c = torch.softmax(b, dim=1)                      # over interests
        z = torch.einsum("bkh,bhd->bkd", c, se)
        u = _squash(z)
        b = b + torch.einsum("bkd,bhd->bkh", u, se)
        b = torch.where(mask[:, None, :], b, neg)
    h = F.relu(u @ params["mlp_w1"] + params["mlp_b1"])
    interests = h @ params["mlp_w2"] + params["mlp_b2"]
    return constrain(interests, "batch", "interests", None)


def label_aware_attention(interests, target_e, p: float):
    """v_u = sum_k softmax((u_k . e_t)^p) u_k."""
    scores = torch.einsum("bkd,bd->bk", interests, target_e)
    w = torch.softmax(torch.abs(scores) ** p * torch.sign(scores), dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


def train_loss(params, batch, cfg: MINDConfig):
    """Sampled-softmax loss.  batch: {hist [B,H], target [B], negatives [B,N]}."""
    interests = user_tower(params, batch["hist"], cfg)
    tgt_e = F.embedding(batch["target"], params["item_embed"])
    v_u = label_aware_attention(interests, tgt_e, cfg.pow_p)
    neg_e = F.embedding(batch["negatives"], params["item_embed"])  # [B,N,d]
    pos_logit = torch.einsum("bd,bd->b", v_u, tgt_e)[:, None]
    neg_logit = torch.einsum("bd,bnd->bn", v_u, neg_e)
    logits = torch.cat([pos_logit, neg_logit], dim=1).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[:, 0].mean()


def score_candidates(params, interests, cand_ids):
    """Retrieval scoring: max over interests of dot(interest, candidate).
    interests [B, K, d]; cand_ids [Nc] -> scores [B, Nc]."""
    cand_e = F.embedding(cand_ids, params["item_embed"])  # [Nc, d]
    cand_e = constrain(cand_e, "candidates", None)
    s = torch.einsum("bkd,nd->bkn", interests, cand_e)
    return s.max(dim=1).values


def serve_step(params, batch, cfg: MINDConfig):
    """Online inference: user histories -> interest vectors."""
    return user_tower(params, batch["hist"], cfg)


def stable_top_k(scores, k: int):
    """(values, positions) of the k largest scores of each row, in
    descending order; among equal scores the lower position first, as
    ``jax.lax.top_k`` (``torch.topk`` leaves that order open)."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def retrieval_step(params, batch, cfg: MINDConfig, top_k: int = 100):
    interests = user_tower(params, batch["hist"], cfg)
    scores = score_candidates(params, interests, batch["candidates"])
    return stable_top_k(scores, top_k)


__all__ = [
    "MINDConfig",
    "init_mind",
    "params_from_numpy",
    "embedding_bag",
    "user_tower",
    "label_aware_attention",
    "train_loss",
    "score_candidates",
    "serve_step",
    "stable_top_k",
    "retrieval_step",
]
