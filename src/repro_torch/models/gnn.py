"""GNN architectures: GCN, GIN, GraphSAGE (the port of ``repro/models/gnn.py``).

Message passing is a gather of the source rows and a segment sum into the
destinations: ``index_add`` under autograd, as the reference's is
``jax.ops.segment_sum``.  Graphs arrive as ``{"x": [N, F], "src": [E],
"dst": [E]}`` (+ ``graph_id`` [N] and ``n_graphs`` for batched small
graphs -> pooled readout; + ``labels`` / ``label_mask`` for the loss).

The parameters are the reference's tree (``{"layers": [per-layer dicts],
"head_w", "head_b"}``) of tensors: ``init_gnn`` draws them from a
``torch.Generator`` on their device, ``params_from_numpy`` carries the
reference's over.  ``gnn_param_axes`` gives the parameters' logical
sharding axes, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain
from repro_torch.models.params import carry_params, draw_params
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                  # gcn | gin | graphsage
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int
    aggregator: str = "mean"   # mean | sum
    readout: Optional[str] = None  # None (node-level) | "sum" | "mean"
    eps_learnable: bool = True     # GIN-eps
    dtype: Any = torch.float32


def _seg_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of the rows of ``values`` into ``n`` segments by ``ids``."""
    return values.new_zeros((n,) + tuple(values.shape[1:])).index_add(0, ids, values)


def aggregate(x, src, dst, n_nodes: int, kind: str):
    """Neighbor aggregation dst <- f(src); the GNN SpMM primitive."""
    out = _seg_sum(x[src], dst, n_nodes)
    if kind == "mean":
        deg = _seg_sum(torch.ones(src.shape, dtype=x.dtype, device=x.device), dst, n_nodes)
        out = out / torch.clamp(deg, min=1.0)[:, None]
    return out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _layout(cfg: GNNConfig) -> Dict:
    """The parameter tree with (shape, scale) leaves: scale None is zeros,
    else a normal draw times the scale (1/sqrt(fan-in))."""
    def dense(shape):
        return (shape, 1.0 / math.sqrt(shape[0]))

    def zeros(*shape):
        return (tuple(shape), None)

    layers = []
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        if cfg.arch == "gcn":
            lp = {"w": dense((d_prev, cfg.d_hidden)), "b": zeros(cfg.d_hidden)}
        elif cfg.arch == "gin":
            lp = {
                "mlp_w1": dense((d_prev, cfg.d_hidden)),
                "mlp_b1": zeros(cfg.d_hidden),
                "mlp_w2": dense((cfg.d_hidden, cfg.d_hidden)),
                "mlp_b2": zeros(cfg.d_hidden),
                "eps": zeros(),
            }
        elif cfg.arch == "graphsage":
            lp = {
                "w_self": dense((d_prev, cfg.d_hidden)),
                "w_nbr": dense((d_prev, cfg.d_hidden)),
                "b": zeros(cfg.d_hidden),
            }
        else:
            raise ValueError(cfg.arch)
        layers.append(lp)
        d_prev = cfg.d_hidden
    return {"layers": layers, "head_w": dense((d_prev, cfg.n_classes)),
            "head_b": zeros(cfg.n_classes)}


def init_gnn(cfg: GNNConfig, generator: torch.Generator, device=None) -> Dict:
    return draw_params(_layout(cfg), cfg.dtype, generator, device)


def gnn_param_axes(params) -> Any:
    """Feature dims shard over ``model`` ('feat'); everything else replicated."""
    return tree_map(lambda p: (None, "feat") if p.ndim == 2 else (None,) * p.ndim, params)


def params_from_numpy(tree: Dict, cfg: GNNConfig, device=None) -> Dict:
    """The reference's ``init_gnn`` tree as numpy arrays -> the port's."""
    return carry_params(_layout(cfg), tree, cfg.dtype, device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def gnn_forward(params, batch, cfg: GNNConfig):
    x = batch["x"].to(cfg.dtype)
    src, dst = batch["src"], batch["dst"]
    n = x.shape[0]

    for li, lp in enumerate(params["layers"]):
        if cfg.arch == "gcn":
            # symmetric normalization with self loops: D^-1/2 (A+I) D^-1/2 X W
            deg = _seg_sum(torch.ones(src.shape, dtype=torch.float32, device=x.device),
                           dst, n) + 1.0
            inv_sqrt = torch.rsqrt(deg)
            msgs = (x * inv_sqrt[:, None])[src]
            agg = _seg_sum(msgs, dst, n) * inv_sqrt[:, None]
            agg = agg + x * (inv_sqrt**2)[:, None]          # self loop
            x = agg @ lp["w"] + lp["b"]
        elif cfg.arch == "gin":
            agg = aggregate(x, src, dst, n, "sum")
            h = (1.0 + lp["eps"]) * x + agg
            h = F.relu(h @ lp["mlp_w1"] + lp["mlp_b1"])
            x = h @ lp["mlp_w2"] + lp["mlp_b2"]
        else:  # graphsage
            agg = aggregate(x, src, dst, n, cfg.aggregator)
            x = x @ lp["w_self"] + agg @ lp["w_nbr"] + lp["b"]
        if li < cfg.n_layers - 1:
            x = F.relu(x)
        x = constrain(x, None, "feat")

    if cfg.readout:
        gid = batch["graph_id"]
        # the batch's n_graphs, as the reference: reading gid.max() syncs
        n_graphs = (batch["n_graphs"] if isinstance(batch.get("n_graphs"), int)
                    else int(gid.max()) + 1)
        pooled = _seg_sum(x, gid, n_graphs)
        if cfg.readout == "mean":
            cnt = _seg_sum(torch.ones(gid.shape, dtype=x.dtype, device=x.device), gid,
                           n_graphs)
            pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
        x = pooled
    return x @ params["head_w"] + params["head_b"]


def gnn_loss(params, batch, cfg: GNNConfig):
    logits = gnn_forward(params, batch, cfg)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    mask = batch.get("label_mask")
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


__all__ = ["GNNConfig", "aggregate", "init_gnn", "gnn_param_axes", "params_from_numpy",
           "gnn_forward", "gnn_loss"]
