"""The language-model family (the port of ``repro/configs/families.py``'s
``LMFamily`` and ``LM_CELLS``): a published config, its reduced CPU config,
its source, its optimizer and its shape cells; ``smoke`` runs one train
step and one decode step of the reduced config, ``model_flops`` counts a
cell's model FLOPs.

Not ported: ``lowerable`` and ``layer_scaled_lowerable``, which build XLA
dry-run programs with shardings (a JAX mechanism: ``launch/dryrun.py``
compiles them for 512 forced host devices), and the GNN, NequIP and RecSys
families (ROADMAP Queue 1 item 16).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import Cell
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt_mod
from repro_torch.tree import tree_leaves
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step

LM_CELLS = {
    "train_4k": Cell("train_4k", "train", dict(seq=4096, batch=256)),
    "prefill_32k": Cell("prefill_32k", "prefill", dict(seq=32768, batch=32)),
    "decode_32k": Cell("decode_32k", "decode", dict(seq=32768, batch=128)),
    "long_500k": Cell(
        "long_500k", "decode", dict(seq=524288, batch=1),
        skip="pure full-attention arch: long_500k is defined for sub-quadratic "
             "attention families only (DESIGN.md §4)",
    ),
}


class LMFamily:
    family = "lm"

    def __init__(self, arch_id: str, cfg: tf.LMConfig, smoke_cfg: tf.LMConfig,
                 source: str, optimizer: str = "adamw", opt_kw: Optional[dict] = None,
                 microbatches: int = 1, rules_override: Optional[dict] = None):
        self.arch_id = arch_id
        self.cfg = cfg
        self.smoke_cfg = smoke_cfg
        self.source = source
        self.optimizer_kind = optimizer
        self.opt_kw = opt_kw or {}
        self.microbatches = microbatches
        # per-arch logical -> mesh rule overrides (data; sharded training is
        # ROADMAP Queue 1 item 16)
        self.rules_override = rules_override
        self.cells = dict(LM_CELLS)

    def optimizer(self):
        kw = dict(self.opt_kw)
        return opt_mod.make_optimizer(self.optimizer_kind, kw.pop("lr", 3e-4), **kw)

    def train_objects(self, model: tf.LM):
        """(optimizer, step) for ``model``: the step takes ``model.params``."""
        optimizer = self.optimizer()
        step = make_train_step(lambda p, b: tf.loss_fn(model, b), optimizer,
                               TrainConfig(microbatches=self.microbatches))
        return optimizer, step

    def layer_count(self) -> int:
        return self.cfg.n_layers

    def model_flops(self, cell_name: str) -> float:
        """6 N_active D for training, 2 N_active D for inference (D the
        tokens processed)."""
        cell = self.cells[cell_name]
        B = cell.meta["batch"]
        S = cell.meta["seq"]
        n = self.cfg.n_active_params
        if cell.kind == "train":
            return 6.0 * n * B * S
        if cell.kind == "prefill":
            return 2.0 * n * B * S
        return 2.0 * n * B  # decode: one token per row

    def smoke(self, seed: int = 0, device=None):
        """One train step and one prefill + decode step of the reduced
        config on ``device`` (the first CUDA card unless given)."""
        device = resolve_device(device)
        cfg = self.smoke_cfg
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model = tf.init_lm(cfg, gen, device)
        B, S = 2, 32
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
        optimizer, step = self.train_objects(model)
        state = init_train_state(model.params, optimizer, TrainConfig())
        new_p, _, metrics = step(model.params, state, {"tokens": toks, "labels": toks})
        params_finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(new_p))
        last, cache = tf.prefill(model, toks, max_seq=S + 4)
        logits, _ = tf.decode_step(model, cache, torch.argmax(last, -1),
                                   torch.full((B,), S, dtype=torch.int32, device=device))
        return {
            "loss": float(metrics["loss"]),
            "logits_finite": bool(torch.isfinite(logits).all()),
            "params_finite": params_finite,
            "decode_shape": tuple(logits.shape),
        }


__all__ = ["LM_CELLS", "LMFamily"]
