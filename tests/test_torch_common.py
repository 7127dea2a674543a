"""Shared helpers for the port's tests (no test functions here).

The port keeps no weights; its state is the graph, the index and the plan.
The counterpart of a weight converter is therefore: build both packages'
graphs from ONE numpy edge list, and compare the port's structures with the
reference's field by field through ``np.asarray``.
"""
import dataclasses

import numpy as np
import torch

import repro.core.temporal_graph as jtg
import repro_torch.core.temporal_graph as ttg

CPU = "cpu"


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def random_edges(n_v: int, n_e: int, seed: int, t_max: int = 1000):
    """A numpy edge list: (src, dst, t_start, t_end)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, n_e)
    dst = rng.integers(0, n_v, n_e)
    ts = rng.integers(0, t_max, n_e)
    te = ts + rng.integers(0, t_max // 10 + 1, n_e)
    return src, dst, ts, te


def both_graphs(src, dst, t_start, t_end=None, n_vertices=None):
    """The reference's and the port's (CPU) graph from one edge list."""
    jg = jtg.from_edges(src, dst, t_start, t_end, n_vertices=n_vertices)
    tg = ttg.from_edges(src, dst, t_start, t_end, n_vertices=n_vertices,
                        device=CPU)
    return jg, tg


def assert_fields_equal(ref, port, names=None):
    """Every named (default: every shared dataclass) field equal, arrays
    exactly, scalars by value; nested dataclasses compared recursively."""
    if names is None:
        port_names = {f.name for f in dataclasses.fields(port)}
        names = [f.name for f in dataclasses.fields(ref) if f.name in port_names]
    for name in names:
        a, b = getattr(ref, name), getattr(port, name)
        if dataclasses.is_dataclass(a):
            assert_fields_equal(a, b)
        elif hasattr(a, "shape") or isinstance(b, torch.Tensor):
            a, b = as_np(a), as_np(b)
            assert a.shape == b.shape, (name, a.shape, b.shape)
            assert (a == b).all(), name
        else:
            assert a == b, (name, a, b)
