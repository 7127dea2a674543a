"""Logical-axis rules: which mesh dimension each logical axis shards over.

A copy of the JAX package's ``DEFAULT_RULES`` table (data, not code).  The
graph side reads two of its entries: ``edges -> ("pod", "data")`` (the
edge partition of the distributed engine and the serving ring's slot
chunks) and ``queries -> "model"`` (the rows of a multi-source batch).
The rest serve the model and training side, whose rule resolution
(``AxisRules``, ``logical_spec``, ``constrain``) is not in the port yet.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]

# default logical -> mesh-axis rules (production mesh: pod/data/model)
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",          # decode-cache sequence (flash-decoding combine)
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "moe_capacity": "data",
    "moe_groups": ("pod", "data"),
    "fsdp": "data",             # ZeRO-3 parameter dimension
    "layers": None,
    "edges": ("pod", "data"),   # graph engine: edge partitioning
    "queries": "model",         # graph engine: multi-source query batches
    "vertices": None,
    "feat": "model",            # GNN feature dim
    "rows": "model",            # embedding-table rows
    "candidates": "model",      # recsys retrieval candidates
    "interests": None,
}

__all__ = ["DEFAULT_RULES", "MeshAxes"]
