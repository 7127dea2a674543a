"""Synthetic temporal graph generators (paper §6 "Datasets").

The edges are drawn in numpy exactly as the JAX package draws them, so the
same seed gives the same edge list in both packages; only the finished
graph goes to ``device``.  ``molecule_batch_graph`` returns numpy COO
arrays, as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.temporal_graph import TemporalGraph, from_edges


def synthetic_temporal_graph(
    n_vertices: int,
    n_edges: int,
    seed: int = 0,
    lognormal_sigma: float = 1.0,
    poisson_lam: float = 2.0,
    max_duration: Optional[int] = None,
    weighted: bool = False,
    *,
    device=None,
) -> TemporalGraph:
    """The paper's synthetic model: vertices ~ lognormal rank, start-time
    inter-arrivals ~ Poisson, durations ~ uniform."""
    rng = np.random.default_rng(seed)

    def pick(n):
        raw = rng.lognormal(mean=0.0, sigma=lognormal_sigma, size=n)
        idx = (raw / raw.max() * (n_vertices - 1)).astype(np.int64)
        return np.clip(idx, 0, n_vertices - 1)

    src = pick(n_edges)
    dst = pick(n_edges)
    coll = src == dst
    dst[coll] = (dst[coll] + 1) % n_vertices

    inter = rng.poisson(lam=poisson_lam, size=n_edges)
    t_start = np.cumsum(inter)
    rng.shuffle(t_start)
    if max_duration is None:
        max_duration = max(int(t_start.max(initial=1) // 10), 1)
    dur = rng.integers(0, max_duration + 1, size=n_edges)
    t_end = t_start + dur
    weight = rng.uniform(0.5, 2.0, size=n_edges).astype(np.float32) if weighted else None
    return from_edges(src, dst, t_start, t_end, weight, n_vertices=n_vertices,
                      device=device)


def power_law_temporal_graph(
    n_vertices: int,
    n_edges: int,
    alpha: float = 1.8,
    seed: int = 0,
    t_max: int = 100_000,
    max_duration: int = 1000,
    weighted: bool = False,
    *,
    device=None,
) -> TemporalGraph:
    """Zipf-degree temporal graph with bursty start times (80% of edges in
    the last 20% of the time range): the skewed regime where selective
    indexing matters most."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_vertices + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    src = rng.choice(n_vertices, size=n_edges, p=probs)
    dst = rng.choice(n_vertices, size=n_edges, p=probs)
    coll = src == dst
    dst[coll] = (dst[coll] + 1) % n_vertices
    burst = rng.random(n_edges) < 0.8
    t_start = np.where(
        burst,
        rng.integers(int(0.8 * t_max), t_max, size=n_edges),
        rng.integers(0, t_max, size=n_edges),
    )
    dur = rng.integers(0, max_duration + 1, size=n_edges)
    weight = rng.uniform(0.5, 2.0, size=n_edges).astype(np.float32) if weighted else None
    return from_edges(src, dst, t_start, t_start + dur, weight,
                      n_vertices=n_vertices, device=device)


def transit_temporal_graph(
    n_vertices: int,
    n_edges: int,
    k: int = 1,
    headway: int = 500,
    seed: int = 0,
    t_max: int = 100_000,
    max_duration: int = 1,
    weighted: bool = False,
    *,
    device=None,
) -> TemporalGraph:
    """Schedule-driven ring network: vertex ``p`` departs toward
    ``p+1..p+k`` at ``p * headway + jitter (mod t_max)``, so earliest-arrival
    depth inside a window is about ``window_width / headway`` rounds."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, size=n_edges)
    hop = rng.integers(1, k + 1, size=n_edges)
    dst = (src + hop) % n_vertices
    jitter = rng.integers(0, max(headway // 2, 1), size=n_edges)
    t_start = (src.astype(np.int64) * headway + jitter) % t_max
    dur = rng.integers(0, max_duration + 1, size=n_edges)
    weight = rng.uniform(0.5, 2.0, size=n_edges).astype(np.float32) if weighted else None
    return from_edges(src, dst, t_start, t_start + dur, weight,
                      n_vertices=n_vertices, device=device)


def molecule_batch_graph(n_nodes: int, n_edges: int, batch: int, seed: int = 0):
    """Batched small graphs (GNN 'molecule' shape): COO edges over a
    disjoint union of ``batch`` molecules plus the graph id of each node,
    as numpy arrays (the reference's draws)."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for b in range(batch):
        s = rng.integers(0, n_nodes, size=n_edges)
        d = rng.integers(0, n_nodes, size=n_edges)
        srcs.append(s + b * n_nodes)
        dsts.append(d + b * n_nodes)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    graph_id = np.repeat(np.arange(batch), n_nodes)
    return src, dst, graph_id


__all__ = [
    "synthetic_temporal_graph",
    "power_law_temporal_graph",
    "transit_temporal_graph",
    "molecule_batch_graph",
]
