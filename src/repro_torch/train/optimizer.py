"""Optimizers over trees of tensors (the port of ``repro/train/optimizer.py``).

AdamW for the normal path; Adafactor (factored second moment, no first
moment) for the configs whose Adam state would not fit; SGD with momentum.
Each is an ``Optimizer(init, update)`` pair as in the reference, and the
state trees have the reference's structure, so a checkpoint's keys match.

Differences from the reference, each deliberate:
- ``update(grads, state, params, step)`` writes the new parameters and the
  new state into the given tensors in place (under ``torch.no_grad``) and
  returns the same trees; the reference returns new arrays.
- ``step`` is a host int.  The schedule and the bias corrections are
  evaluated on float32 0-d tensors, as the reference evaluates them on its
  traced float32 step.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]
    # update(grads, state, params, step) -> (params, state), both in place


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warm-up, then cosine decay to ``min_ratio`` x ``base_lr``,
    evaluated in float32; returns the rate as a Python float."""
    def schedule(step) -> float:
        step = _f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return float(torch.where(step < warmup_steps, warm, cos))

    return schedule


def _rate(lr):
    return lr if callable(lr) else (lambda _: lr)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype=torch.float32) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        stepf = _f32(step) + 1.0
        lr_t = lr_fn(step)
        bc1 = float(1.0 - b1 ** stepf)
        bc2 = float(1.0 - b2 ** stepf)

        def upd(p, g, m, v):
            g32 = g.float()
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * g32 * g32
            mh = m_new / bc1
            vh = v_new / bc2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            p.copy_((p.float() - lr_t * delta).to(p.dtype))
            m.copy_(m_new.to(state_dtype))
            v.copy_(v_new.to(state_dtype))
            return p

        with torch.no_grad():
            tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; memory O(rows + cols) per matrix)
# ---------------------------------------------------------------------------

def _factored(shape, min_dim: int = 128) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim_size_to_factor: int = 128) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape, min_dim_size_to_factor):
                return {"vr": torch.zeros(p.shape[:-1], **f32),                 # row
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}  # col
            return {"v": torch.zeros(p.shape, **f32)}

        return tree_map(one, params)

    def update(grads, state, params, step):
        beta2_t = 1.0 - (_f32(step) + 1.0) ** (-decay)
        beta2, one_minus = float(beta2_t), float(1 - beta2_t)
        lr_t = lr_fn(step)

        def upd(p, g, s):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if "vr" in s:
                vr = beta2 * s["vr"] + one_minus * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + one_minus * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                u = g32 * torch.rsqrt(vr / torch.clamp(denom, min=eps))[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta2 * s["v"] + one_minus * g2
                u = g32 * torch.rsqrt(v)
                s["v"].copy_(v)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            delta = u + weight_decay * p.float()
            p.copy_((p.float() - lr_t * delta).to(p.dtype))
            return p

        with torch.no_grad():
            tree_map(upd, params, grads, state)
        return params, state

    return Optimizer(init, update)


def sgd(lr, momentum: float = 0.9) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    def update(grads, state, params, step):
        lr_t = lr_fn(step)

        def upd(p, g, m):
            m_new = momentum * m + g.float()
            p.copy_((p.float() - lr_t * m_new).to(p.dtype))
            m.copy_(m_new)
            return p

        with torch.no_grad():
            tree_map(upd, params, grads, state)
        return params, state

    return Optimizer(init, update)


def make_optimizer(kind: str, lr, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[kind](lr, **kw)


def state_axes(kind: str, param_axes_tree, param_shapes_tree):
    """Logical axes of the optimizer state, mirroring the parameters' (the
    state shards as its parameter).  A shapes leaf is a tensor or a shape."""
    if kind == "adamw":
        return {"m": param_axes_tree, "v": param_axes_tree}
    if kind == "sgd":
        return param_axes_tree
    if kind == "adafactor":
        def one(ax, shaped):
            if _factored(tuple(getattr(shaped, "shape", shaped))):
                return {"vr": tuple(ax[:-1]), "vc": tuple(ax[:-2]) + (ax[-1],)}
            return {"v": tuple(ax)}

        return tree_map(one, param_axes_tree, param_shapes_tree)
    raise ValueError(kind)


__all__ = ["Optimizer", "global_norm", "clip_by_global_norm", "warmup_cosine", "adamw",
           "adafactor", "sgd", "make_optimizer", "state_axes"]
