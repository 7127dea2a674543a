"""Architecture families (the port of ``repro/configs/families.py``): the
language models (``LMFamily``, ``LM_CELLS``), the GNNs (``GNNFamily``,
``GNN_CELLS``), NequIP (``NequIPFamily``) and MIND (``RecsysFamily``,
``RECSYS_CELLS``).  A family holds a published config, its source and its
shape cells; ``smoke`` runs a reduced config on a device, ``model_flops``
counts a cell's model FLOPs (equal to the reference's), and
``train_objects`` builds the optimizer and train step that the reference's
dry run compiles for a cell.  An ``LMFamily`` trains sharded on a
``DeviceMesh``: ``shard`` places a model's parameters as DTensors by
``param_axes`` under the family's ``rules_override``, and
``train_objects(model, mesh)`` runs its step under ``use_mesh`` with those
rules, as the reference's ``lowerable`` does.

Not ported: ``lowerable`` and ``layer_scaled_lowerable``, which build XLA
dry-run programs with shardings (a JAX mechanism: ``launch/dryrun.py``
compiles them for 512 forced host devices).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, Cell
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import distribute_tree, use_mesh
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import mind as mind_mod
from repro_torch.models import nequip as nequip_mod
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


class LMFamily(ArchSpec):
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
        # per-arch logical -> mesh rule overrides, live under a mesh
        self.rules_override = rules_override
        self.cells = dict(LM_CELLS)

    def optimizer(self):
        kw = dict(self.opt_kw)
        return opt_mod.make_optimizer(self.optimizer_kind, kw.pop("lr", 3e-4), **kw)

    def train_objects(self, model: tf.LM, mesh=None):
        """(optimizer, step) for ``model``: the step takes ``model.params``.
        With ``mesh`` (a model from ``shard``) it runs under ``use_mesh`` with
        the family's rules."""
        optimizer = self.optimizer()
        step = make_train_step(lambda p, b: tf.loss_fn(model, b), optimizer,
                               TrainConfig(microbatches=self.microbatches))
        if mesh is None:
            return optimizer, step
        rules = self.rules_override

        def sharded_step(params, state, batch):
            with use_mesh(mesh, rules=rules):
                return step(params, state, batch)

        return optimizer, sharded_step

    @staticmethod
    def mesh_cfg(cfg: tf.LMConfig, mesh) -> tf.LMConfig:
        """Mesh-dependent config tweaks: MoE dispatch groups track the
        batch-sharding degree (group-local dispatch, the reference's
        ``_mesh_cfg``)."""
        if cfg.moe is None or mesh is None:
            return cfg
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        g = sizes.get("pod", 1) * sizes.get("data", 1)
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_groups=g))

    def shard(self, model: tf.LM, mesh) -> tf.LM:
        """``model``'s parameters as DTensors on ``mesh`` (every rank passes
        the same values), placed by ``param_axes`` under the family's rules;
        the config is ``mesh_cfg``'s."""
        cfg = self.mesh_cfg(model.cfg, mesh)
        return tf.LM(cfg, distribute_tree(model.params, tf.param_axes(cfg), mesh,
                                          self.rules_override))

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


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _params(init, carry, cfg, seed, device, params):
    """The smoke run's weights: ``params`` (the reference's tree as numpy
    arrays) carried over when given, else drawn from ``seed``."""
    if params is not None:
        return carry(params, cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init(cfg, gen, device)


def _loss_and_grads(loss_fn, params):
    """``loss_fn(params)`` and its gradients with respect to every leaf."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


# ===========================================================================
# GNN family (gcn / gin / graphsage)
# ===========================================================================

GNN_CELLS = {
    "full_graph_sm": Cell(
        "full_graph_sm", "train",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
    ),
    "minibatch_lg": Cell(
        "minibatch_lg", "train",
        dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
             fanout=(15, 10), d_feat=602, n_classes=41,
             # sampled-subgraph shapes consumed by the train step:
             sub_nodes=1024 + 1024 * 15 + 1024 * 150,
             sub_edges=1024 * 15 + 1024 * 150),
    ),
    "ogb_products": Cell(
        "ogb_products", "train",
        dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47),
    ),
    "molecule": Cell(
        "molecule", "train",
        dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=2),
    ),
}


def _cell_sizes(cell: Cell):
    """(nodes, edges) of one train step of a GNN cell."""
    m = cell.meta
    if cell.name == "molecule":
        return m["n_nodes"] * m["batch"], m["n_edges"] * m["batch"]
    return m.get("sub_nodes", m["n_nodes"]), m.get("sub_edges", m["n_edges"])


class GNNFamily(ArchSpec):
    family = "gnn"

    def __init__(self, arch_id: str, arch: str, n_layers: int, d_hidden: int,
                 source: str, aggregator: str = "mean", readout_molecule: str = "sum"):
        self.arch_id = arch_id
        self.arch = arch
        self.n_layers = n_layers
        self.d_hidden = d_hidden
        self.aggregator = aggregator
        self.readout_molecule = readout_molecule
        self.source = source
        self.cells = dict(GNN_CELLS)

    def cfg_for(self, cell_name: str) -> gnn_mod.GNNConfig:
        """The model config of a cell (the reference's ``_cfg``)."""
        cell = self.cells[cell_name]
        m = cell.meta
        return gnn_mod.GNNConfig(
            name=self.arch_id, arch=self.arch, n_layers=self.n_layers,
            d_hidden=self.d_hidden, d_in=m["d_feat"], n_classes=m["n_classes"],
            aggregator=self.aggregator,
            readout=self.readout_molecule if cell.name == "molecule" else None,
        )

    def train_objects(self, cell_name: str):
        """(optimizer, step) of the cell's train step: AdamW at 1e-3 on
        ``gnn_loss`` of ``cfg_for(cell_name)``, the molecule cell's batch
        pooled into its ``batch`` graphs."""
        cell = self.cells[cell_name]
        cfg = self.cfg_for(cell_name)
        n_graphs = cell.meta["batch"] if cell.name == "molecule" else None
        optimizer = opt_mod.make_optimizer("adamw", 1e-3)

        def loss(p, b):
            return gnn_mod.gnn_loss(p, {**b, "n_graphs": n_graphs} if n_graphs else b,
                                    cfg), {}

        return optimizer, make_train_step(loss, optimizer, TrainConfig())

    def model_flops(self, cell_name: str) -> float:
        cfg = self.cfg_for(cell_name)
        n, e = _cell_sizes(self.cells[cell_name])
        per_layer = 2.0 * e * cfg.d_hidden + 3 * 2.0 * n * cfg.d_hidden * cfg.d_hidden
        first = 2.0 * e * cfg.d_in + 3 * 2.0 * n * cfg.d_in * cfg.d_hidden
        fwd = first + (cfg.n_layers - 1) * per_layer + 2.0 * n * cfg.d_hidden * cfg.n_classes
        return 3.0 * fwd  # train: fwd + 2x bwd

    def smoke_cfg(self) -> gnn_mod.GNNConfig:
        return gnn_mod.GNNConfig(
            name=self.arch_id, arch=self.arch, n_layers=min(self.n_layers, 2),
            d_hidden=8, d_in=6, n_classes=3, aggregator=self.aggregator,
        )

    def smoke(self, seed: int = 0, device=None, params=None):
        """Forward, loss and gradients of the reduced config on a 40-node,
        160-edge graph drawn from ``seed`` (the reference's draws), on
        ``device`` (the first CUDA card unless given); ``params`` carries
        the reference's weights over."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        cfg = self.smoke_cfg()
        p = _params(gnn_mod.init_gnn, gnn_mod.params_from_numpy, cfg, seed, device, params)
        N, E = 40, 160
        batch = {
            "x": torch.as_tensor(rng.standard_normal((N, 6)), dtype=torch.float32),
            "src": torch.as_tensor(rng.integers(0, N, E), dtype=torch.int32),
            "dst": torch.as_tensor(rng.integers(0, N, E), dtype=torch.int32),
            "labels": torch.as_tensor(rng.integers(0, 3, N), dtype=torch.int32),
        }
        batch = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            out = gnn_mod.gnn_forward(p, batch, cfg)
        loss, grads = _loss_and_grads(lambda q: gnn_mod.gnn_loss(q, batch, cfg), p)
        return {
            "out_shape": tuple(out.shape),
            "loss": float(loss),
            "finite": _finite(out, *grads),
        }


# ===========================================================================
# NequIP family
# ===========================================================================

class NequIPFamily(ArchSpec):
    family = "gnn"

    def __init__(self, arch_id: str, cfg: nequip_mod.NequIPConfig, source: str):
        self.arch_id = arch_id
        self.cfg = cfg
        self.source = source
        self.cells = dict(GNN_CELLS)

    def train_objects(self, cell_name: str):
        """(optimizer, step) of the cell's train step: AdamW at 1e-3 on the
        energy MSE (the reference's dry-run loss: no forces, so no double
        backward)."""
        cell = self.cells[cell_name]
        n_graphs = cell.meta["batch"] if cell.name == "molecule" else 1
        cfg = self.cfg
        optimizer = opt_mod.make_optimizer("adamw", 1e-3)

        def loss(p, b):
            e = nequip_mod.nequip_forward(p, {**b, "n_graphs": n_graphs}, cfg)
            return torch.mean((e - b["energy_target"]) ** 2), {"e_mean": e.mean()}

        return optimizer, make_train_step(loss, optimizer, TrainConfig())

    def model_flops(self, cell_name: str) -> float:
        cfg = self.cfg
        n, e = _cell_sizes(self.cells[cell_name])
        C = cfg.d_hidden
        tp = sum(
            2.0 * e * C * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
            for (l1, l2, l3) in cfg.paths
        )
        radial = 2.0 * e * (cfg.n_rbf * 32 + 32 * len(cfg.paths) * C)
        mixes = 2.0 * n * C * C * 2 * (cfg.l_max + 1)
        fwd = cfg.n_layers * (tp + radial + mixes)
        return 3.0 * fwd

    def smoke_cfg(self) -> nequip_mod.NequIPConfig:
        return dataclasses.replace(self.cfg, n_layers=2, d_hidden=8, n_species=4)

    def smoke(self, seed: int = 0, device=None, params=None):
        """Energy and forces of the reduced config on 10 atoms drawn from
        ``seed`` (the reference's draws), on ``device``; ``params`` carries
        the reference's weights over."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        cfg = self.smoke_cfg()
        p = _params(nequip_mod.init_nequip, nequip_mod.params_from_numpy, cfg, seed,
                    device, params)
        N = 10
        pos = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
        dmat = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        src, dst = np.nonzero((dmat < cfg.cutoff) & (dmat > 0))
        batch = {
            "species": torch.as_tensor(rng.integers(0, 4, N), dtype=torch.int32),
            "pos": torch.as_tensor(pos),
            "src": torch.as_tensor(src, dtype=torch.int32),
            "dst": torch.as_tensor(dst, dtype=torch.int32),
        }
        batch = {k: v.to(device) for k, v in batch.items()}
        e, f = nequip_mod.nequip_energy_forces(p, batch, cfg)
        return {
            "energy": float(e),
            "forces_shape": tuple(f.shape),
            "finite": _finite(e, f),
        }


# ===========================================================================
# RecSys family (MIND)
# ===========================================================================

RECSYS_CELLS = {
    "train_batch": Cell("train_batch", "train", dict(batch=65536)),
    "serve_p99": Cell("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": Cell("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": Cell(
        "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)
    ),
}


class RecsysFamily(ArchSpec):
    family = "recsys"

    def __init__(self, arch_id: str, cfg: mind_mod.MINDConfig, source: str):
        self.arch_id = arch_id
        self.cfg = cfg
        self.source = source
        self.cells = dict(RECSYS_CELLS)

    def train_objects(self, cfg: Optional[mind_mod.MINDConfig] = None):
        """(optimizer, step) of the train cell: AdamW at 1e-3 on the
        sampled-softmax ``train_loss`` (of ``cfg``, the family's unless
        given)."""
        cfg = cfg or self.cfg
        optimizer = opt_mod.make_optimizer("adamw", 1e-3)
        step = make_train_step(lambda p, b: (mind_mod.train_loss(p, b, cfg), {}),
                               optimizer, TrainConfig())
        return optimizer, step

    def model_flops(self, cell_name: str) -> float:
        cell = self.cells[cell_name]
        cfg = self.cfg
        B = cell.meta["batch"]
        d, K, H = cfg.embed_dim, cfg.n_interests, cfg.hist_len
        tower = B * (
            2.0 * H * d * d                      # bilinear
            + cfg.capsule_iters * 2 * 2.0 * K * H * d
            + 2 * 2.0 * K * d * 4 * d            # interest MLP
        )
        if cell.kind == "train":
            return 3.0 * (tower + 2.0 * B * (1 + cfg.n_negatives) * d)
        if cell.kind == "retrieval":
            return tower + 2.0 * B * K * cell.meta["n_candidates"] * d
        return tower

    def smoke_cfg(self) -> mind_mod.MINDConfig:
        return dataclasses.replace(self.cfg, n_items=500, hist_len=12, n_negatives=16)

    def smoke(self, seed: int = 0, device=None, params=None):
        """Loss, gradients and interests of the reduced config (500 items)
        on 4 users drawn from ``seed`` (the reference's draws), on
        ``device``; ``params`` carries the reference's weights over."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        cfg = self.smoke_cfg()
        p = _params(mind_mod.init_mind, mind_mod.params_from_numpy, cfg, seed, device,
                    params)
        B = 4
        batch = {
            "hist": torch.as_tensor(rng.integers(0, 500, (B, 12)), device=device),
            "target": torch.as_tensor(rng.integers(1, 500, (B,)), device=device),
            "negatives": torch.as_tensor(rng.integers(1, 500, (B, 16)), device=device),
        }
        loss, grads = _loss_and_grads(lambda q: mind_mod.train_loss(q, batch, cfg), p)
        with torch.no_grad():
            interests = mind_mod.user_tower(p, batch["hist"], cfg)
        return {
            "loss": float(loss),
            "interests_shape": tuple(interests.shape),
            "finite": _finite(interests, *grads),
        }


__all__ = ["LM_CELLS", "LMFamily", "GNN_CELLS", "GNNFamily", "NequIPFamily",
           "RECSYS_CELLS", "RecsysFamily"]
