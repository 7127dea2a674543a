"""Neighbor sampling for minibatch GNN training (GraphSAGE fanout sampling).

Host-side, vectorized numpy, the JAX package's code unchanged: builds a CSR
once, then per batch samples a fixed fanout per hop (with replacement, as
in the GraphSAGE reference implementation's default) and emits a
renumbered subgraph whose shapes are STATIC (the minibatch_lg cell's).  The
same seeds and ``np.random.Generator`` give the reference's arrays bit for
bit; tensors are made only at the boundary (:func:`batch_to_device`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class NeighborSampler:
    offsets: np.ndarray      # i64[V+1] CSR
    neighbors: np.ndarray    # i64[E]
    fanouts: Sequence[int]

    @classmethod
    def from_edges(cls, src, dst, n_vertices: int, fanouts: Sequence[int]):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        order = np.argsort(src, kind="stable")
        neighbors = dst[order]
        counts = np.bincount(src, minlength=n_vertices)
        offsets = np.zeros(n_vertices + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(offsets, neighbors, tuple(fanouts))

    def sample(self, seeds: np.ndarray, rng: np.random.Generator):
        """Returns (nodes, src, dst, seed_mask): a block subgraph where
        ``nodes`` are original ids (seeds first), edges are in renumbered id
        space, and every hop contributes exactly len(frontier) x fanout
        edges (isolated nodes self-loop), keeping shapes static."""
        nodes = [np.asarray(seeds, np.int64)]
        edges_src, edges_dst = [], []
        node_index = {int(v): i for i, v in enumerate(nodes[0])}
        all_nodes = list(nodes[0])
        frontier = nodes[0]
        for fanout in self.fanouts:
            deg = self.offsets[frontier + 1] - self.offsets[frontier]
            # with-replacement sample; degree-0 nodes self-loop
            r = rng.integers(0, 2**31, size=(len(frontier), fanout))
            idx = self.offsets[frontier][:, None] + r % np.maximum(deg, 1)[:, None]
            nbr = np.where(
                deg[:, None] > 0, self.neighbors[idx], frontier[:, None]
            )
            flat_dst = np.repeat(frontier, fanout)
            flat_src = nbr.reshape(-1)
            new_frontier = []
            for v in flat_src:
                vi = int(v)
                if vi not in node_index:
                    node_index[vi] = len(all_nodes)
                    all_nodes.append(vi)
                    new_frontier.append(vi)
            edges_src.append(flat_src)
            edges_dst.append(flat_dst)
            frontier = np.asarray(flat_src, np.int64)
        nodes_arr = np.asarray(all_nodes, np.int64)
        remap = np.vectorize(node_index.__getitem__, otypes=[np.int64])
        src = remap(np.concatenate(edges_src))
        dst = remap(np.concatenate(edges_dst))
        seed_mask = np.zeros(len(nodes_arr), np.float32)
        seed_mask[: len(seeds)] = 1.0
        return nodes_arr, src.astype(np.int32), dst.astype(np.int32), seed_mask

    def sample_padded(self, seeds, rng, n_nodes_pad: int, n_edges_pad: int,
                      features: np.ndarray, labels: np.ndarray):
        """Static-shape batch matching the minibatch_lg cell specs."""
        nodes, src, dst, seed_mask = self.sample(seeds, rng)
        nn, ne = len(nodes), len(src)
        if nn > n_nodes_pad or ne > n_edges_pad:
            raise ValueError(f"sample exceeds pad: {nn}/{n_nodes_pad} nodes, {ne}/{n_edges_pad} edges")
        x = np.zeros((n_nodes_pad, features.shape[1]), np.float32)
        x[:nn] = features[nodes]
        y = np.zeros(n_nodes_pad, np.int32)
        y[:nn] = labels[nodes]
        mask = np.zeros(n_nodes_pad, np.float32)
        mask[:nn] = seed_mask
        sp = np.zeros(n_edges_pad, np.int32)
        dp = np.zeros(n_edges_pad, np.int32)
        sp[:ne] = src
        dp[:ne] = dst
        return {"x": x, "src": sp, "dst": dp, "labels": y, "label_mask": mask}


def batch_to_device(batch, device):
    """A sampled batch of numpy arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


__all__ = ["NeighborSampler", "batch_to_device"]
