"""The train step (the port of ``repro/train/train_step.py``): loss ->
gradients (``torch.autograd``) -> compression -> clip -> optimizer, with
optional microbatch accumulation.

``params`` is a tree of tensors (an ``LM``'s ``model.params``); the step
makes each leaf require gradients, takes the gradients of the loss with
respect to the leaves, and updates them in place through the optimizer.
With microbatches the gradients accumulate in float32 zeros, the loss is
the mean over microbatches and the metrics are the last microbatch's, as
in the reference.  ``state["step"]`` is a host int.

Not ported: ``jit_train_step``, which jit-compiles the step with shardings
and donated buffers (JAX mechanisms; PyTorch runs the step eagerly, and
the in-place updates stand in for donation).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.distributed.compression import (
    CompressionConfig,
    compress_gradients,
    init_error_feedback,
)
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_grad_norm: float = 1.0
    microbatches: int = 1
    compression: CompressionConfig = CompressionConfig()


def init_train_state(params, optimizer: Optimizer, tcfg: TrainConfig) -> Dict[str, Any]:
    state = {"opt": optimizer.init(params), "step": 0}
    if tcfg.compression.kind != "none":
        state["err_fb"] = init_error_feedback(params)
    return state


def _detached(metrics):
    return tree_map(lambda m: m.detach() if isinstance(m, torch.Tensor) else m, metrics)


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    tcfg: TrainConfig = TrainConfig()):
    """Returns step(params, state, batch) -> (params, state, metrics);
    ``loss_fn(params, batch) -> (loss, metrics)``."""

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), _detached(metrics), tree_unflatten(params, grads)

    def compute_grads(params, batch):
        n = tcfg.microbatches
        if n <= 1:
            return grads_of(params, batch)
        split = tree_map(lambda x: x.reshape(n, x.shape[0] // n, *x.shape[1:]), batch)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        loss_sum = 0.0
        for i in range(n):
            loss, metrics, grads = grads_of(params, tree_map(lambda x: x[i], split))
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss.float()
        return loss_sum / n, metrics, tree_map(lambda g: g / n, acc)

    def step(params, state, batch):
        loss, metrics, grads = compute_grads(params, batch)
        compressed = tcfg.compression.kind != "none"
        if compressed:
            grads, new_err = compress_gradients(grads, state["err_fb"], tcfg.compression)
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        params, new_opt = optimizer.update(grads, state["opt"], params, state["step"])
        new_state = {"opt": new_opt, "step": state["step"] + 1}
        if compressed:
            new_state["err_fb"] = new_err
        return params, new_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return step


__all__ = ["TrainConfig", "init_train_state", "make_train_step"]
