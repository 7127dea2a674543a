"""The paper's synthetic temporal graph (§6), drawn in numpy at a size the
serving layer builds on the host, and loaded into the port through
``from_edges`` and ``build_tger``.

``generate`` is a frozen copy of the draw of ``synthetic_temporal_graph``
(the generator both packages share): endpoints of lognormal rank
(``lognormal_sigma``), start times the cumulative sum of Poisson gaps
(``poisson_gap``) in a random order, durations uniform up to a tenth of
the last start (``duration_max_share``).  The configuration's
``graph_seed`` draws the graph and the run's seed relabels its vertices
by a random permutation (``relabel``: the run's id of each vertex as
drawn), so every seed gets the same graph under other names, and the same
work.  The benchmark keeps these raw arrays: traffic and the reference
read them, never the program's graph."""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np


class Edges(NamedTuple):
    src: np.ndarray   # i64[E]
    dst: np.ndarray
    ts: np.ndarray
    te: np.ndarray
    n_vertices: int
    relabel: np.ndarray   # i64[V]: the run's id of each vertex as drawn (by rank)


class System(NamedTuple):
    g: object         # repro_torch TemporalGraph
    tger: object      # repro_torch TGERIndex


def generate(config: dict, seed: int, device) -> Edges:
    del device
    n_v, n_e = config["vertices"], config["edges"]
    rng = np.random.default_rng(config["graph_seed"])

    def pick(n):
        raw = rng.lognormal(mean=0.0, sigma=config["lognormal_sigma"], size=n)
        idx = (raw / raw.max() * (n_v - 1)).astype(np.int64)
        return np.clip(idx, 0, n_v - 1)

    src = pick(n_e)
    dst = pick(n_e)
    coll = src == dst
    dst[coll] = (dst[coll] + 1) % n_v
    t_start = np.cumsum(rng.poisson(lam=config["poisson_gap"], size=n_e))
    rng.shuffle(t_start)
    max_duration = max(int(t_start.max(initial=1) * config["duration_max_share"]), 1)
    t_end = t_start + rng.integers(0, max_duration + 1, size=n_e)
    relabel = np.random.default_rng([seed, 0]).permutation(n_v).astype(np.int64)
    return Edges(relabel[src], relabel[dst], t_start.astype(np.int64),
                 t_end.astype(np.int64), n_v, relabel)


def load(config: dict, edges: Edges, device, sync):
    """The port's graph and TGER index; returns ``(system, seconds)``, the
    seconds of the graph build (host clock, synchronized)."""
    from repro_torch.core.temporal_graph import from_edges
    from repro_torch.core.tger import build_tger

    sync()
    t0 = time.perf_counter()
    g = from_edges(edges.src, edges.dst, edges.ts, edges.te, n_vertices=edges.n_vertices,
                   device=device)
    tger = build_tger(g, degree_cutoff=config["degree_cutoff"])
    sync()
    return System(g, tger), time.perf_counter() - t0


def close(system) -> None:
    del system


__all__ = ["Edges", "System", "generate", "load", "close"]
