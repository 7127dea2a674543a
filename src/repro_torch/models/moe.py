"""Mixture-of-Experts FFN with sort-based dispatch (the port of
``repro/models/moe.py``).

Top-k routing -> sort the token-expert pairs by expert (a stable sort, as
the reference's ``argsort``) -> pack them into per-expert capacity buffers
``[G, E, C, d]`` with one overflow spill row past the last slot -> grouped
products over the expert axis -> a weighted segment sum back to the tokens.
A pair past its expert's capacity lands in the spill row, which is cut off,
so exactly the reference's pairs are dropped.  ``n_groups`` splits the
tokens into dispatch groups, each sorted and packed on its own (the
reference's ``vmap``, here a loop over the groups).  The expert products
are ``torch.einsum``: the reference leaves them to XLA, outside any Pallas
kernel.  The Switch auxiliary loss is taken over all tokens.

The reference's ``constrain`` layout hints are kept at its sites (the
identity without a mesh).  Under a DTensor mesh the dispatch and the
combine (sort, searchsorted, ``index_put``, ``index_add``: ops with no
DTensor sharding rule) run through ``local_map`` on each rank's own
dispatch groups, the group axis sharded as ``"moe_groups"`` and every other
axis whole: the reference's ``vmap`` over data-sharded groups.  The expert
products between them run on DTensors, experts over ``"model"``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import axis0_local, constrain, full_value, local_einsum
from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden size
    n_shared: int = 0           # shared (always-on) experts, DeepSeek/Kimi style
    capacity_factor: float = 1.25
    n_groups: int = 1           # dispatch groups (== data shards at scale)
    # every expert on every token, then a weighted select (decode-sized T)
    dense_mix: bool = False


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig):
    """(params, axes) of one MoE layer, drawn from ``generator`` on its
    device with the reference's ``dense_init`` rule."""
    E, F_ = cfg.n_experts, cfg.d_ff
    axes = {
        "router": (None, None),
        "w_gate": ("experts", "fsdp", None),
        "w_up": ("experts", "fsdp", None),
        "w_down": ("experts", None, "fsdp"),
    }
    shapes = {"router": (d_model, E), "w_gate": (E, d_model, F_), "w_up": (E, d_model, F_),
              "w_down": (E, F_, d_model)}
    params = {k: dense_init(generator, shapes[k], axes[k])[0] for k in shapes}
    if cfg.n_shared:
        Fs = cfg.d_ff * cfg.n_shared
        axes["shared"] = {"w_gate": ("fsdp", "mlp"), "w_up": ("fsdp", "mlp"),
                          "w_down": ("mlp", "fsdp")}
        shapes = {"w_gate": (d_model, Fs), "w_up": (d_model, Fs), "w_down": (Fs, d_model)}
        params["shared"] = {k: dense_init(generator, shapes[k], axes["shared"][k])[0]
                            for k in shapes}
    return params, axes


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Per-group expert capacity (group-local tokens), a multiple of 8."""
    per_group = n_tokens // cfg.n_groups
    c = int(per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return -(-c // 8) * 8


def _dispatch_group(x, top_w, top_ids, E: int, K: int, C: int):
    """One group's sort-based dispatch.  x [T, d]; top_w / top_ids [T, K] ->
    (buf [E, C, d], slot [T*K], token_of, keep, pair_w)."""
    T, d = x.shape
    dev = x.device
    flat_e = top_ids.reshape(-1)                                  # [T*K]
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    token_of = order // K
    start_of = torch.searchsorted(sorted_e, torch.arange(E, device=dev, dtype=sorted_e.dtype))
    pos_in_e = torch.arange(T * K, device=dev) - start_of[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)      # overflow spill row
    buf = x.new_zeros((E * C + 1, d)).index_put((slot,), x[token_of])
    buf = buf[: E * C].reshape(E, C, d)
    pair_w = top_w.reshape(-1)[order]
    return buf, slot, token_of, keep, pair_w


def _combine_group(out_buf, slot, token_of, keep, pair_w, T: int):
    """Expert outputs back to the tokens: [E*C, d] -> [T, d] (segment sum)."""
    EC, d = out_buf.shape
    gathered = out_buf[torch.clamp(slot, max=EC - 1)] * torch.where(keep, pair_w, 0.0)[:, None]
    return out_buf.new_zeros((T, d)).index_add(0, token_of, gathered)


def _route(params, x, cfg: MoEConfig):
    """Router probabilities [T, E] (float32), the top-k ids and weights
    (renormalised), and the Switch auxiliary loss over all T tokens."""
    T = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: among equal probabilities the lower expert
    # id goes first, as ``jax.lax.top_k`` orders them (``torch.topk`` does not);
    # each token's row sorts on its own (under DTensor, on its rank)
    top_w, top_ids = axis0_local(
        lambda p: tuple(torch.sort(p, dim=-1, descending=True, stable=True)), 2, probs)
    top_w, top_ids = top_w[:, :K], top_ids[:, :K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    # the ids' counts per expert (bincount's integers, as a scatter of ones:
    # bincount has no meta kernel); a scatter has no DTensor sharding rule
    # here, so every rank counts all the ids
    ids = full_value(top_ids).reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    ce = counts.to(probs.dtype) / (T * K)
    return probs, top_w, top_ids, E * torch.sum(me * ce)


def _shared(params, x, out):
    sh = params["shared"]
    dt = x.dtype
    hs = F.silu(x @ sh["w_gate"].to(dt)) * (x @ sh["w_up"].to(dt))
    return out + hs @ sh["w_down"].to(dt)


def _moe_dense_mix(params, x, cfg: MoEConfig):
    """Every expert on every token, then the gate's weighted select."""
    T = x.shape[0]
    dt = x.dtype
    _, top_w, top_ids, aux = _route(params, x, cfg)
    gate = torch.zeros((T, cfg.n_experts), dtype=torch.float32, device=x.device)
    gate = gate.scatter(1, top_ids, top_w)
    h = F.silu(local_einsum("td,edf->tef", x, params["w_gate"].to(dt))) * local_einsum(
        "td,edf->tef", x, params["w_up"].to(dt))
    h = constrain(h, None, "experts", None)
    out_e = local_einsum("tef,efd->ted", h, params["w_down"].to(dt))
    out = local_einsum("ted,te->td", out_e, gate.to(dt))
    if cfg.n_shared:
        out = _shared(params, x, out)
    return out.to(dt), aux


def moe_ffn(params, x, cfg: MoEConfig, dtype=None):
    """x: [T, d] -> (out [T, d], aux loss)."""
    if cfg.dense_mix:
        return _moe_dense_mix(params, x, cfg)
    T, d = x.shape
    E, K, G = cfg.n_experts, cfg.top_k, cfg.n_groups
    if T % G:
        raise ValueError(f"tokens {T} must divide into {G} dispatch groups")
    Tg = T // G
    C = capacity(T, cfg)
    dt = x.dtype
    _, top_w, top_ids, aux = _route(params, x, cfg)
    top_w = top_w.to(dt)

    # group-local dispatch; the input layout is pinned: groups over data,
    # tokens within a group local
    xg = constrain(x.reshape(G, Tg, d), "moe_groups", None, None)
    wg_, ig_ = top_w.reshape(G, Tg, K), top_ids.reshape(G, Tg, K)

    def dispatch(xg, wg_, ig_):
        groups = [_dispatch_group(xg[g], wg_[g], ig_[g], E, K, C) for g in range(xg.shape[0])]
        return tuple(torch.stack(f) for f in zip(*groups))

    buf, *route = axis0_local(dispatch, 5, xg, wg_, ig_)
    # buf [G, E, C, d]: G over data (the token -> expert all-to-all
    # boundary), experts over model (EP)
    buf = constrain(buf, "moe_groups", "experts", None, None)

    # grouped expert computation
    h = F.silu(local_einsum("gecd,edf->gecf", buf, params["w_gate"].to(dt))) * local_einsum(
        "gecd,edf->gecf", buf, params["w_up"].to(dt))
    h = constrain(h, "moe_groups", "experts", None, None)
    out_buf = local_einsum("gecf,efd->gecd", h, params["w_down"].to(dt)).reshape(G, E * C, d)
    out_buf = constrain(out_buf, "moe_groups", None, None)

    # weighted scatter back (group-local)
    def combine(out_buf, *route):
        return torch.stack([_combine_group(out_buf[g], *(r[g] for r in route), Tg)
                            for g in range(out_buf.shape[0])])

    out = axis0_local(combine, 1, out_buf, *route).reshape(T, d)
    if cfg.n_shared:
        out = _shared(params, x, out)
    return out.to(dt), aux


__all__ = ["MoEConfig", "init_moe", "capacity", "moe_ffn"]
