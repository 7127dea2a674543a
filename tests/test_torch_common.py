"""Shared helpers for the port's tests (no test functions here).

The port keeps no weights; its state is the graph, the index and the plan.
The counterpart of a weight converter is therefore: build both packages'
graphs from ONE numpy edge list, and compare the port's structures with the
reference's field by field through ``np.asarray``.
"""
import contextlib
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.core.temporal_graph as jtg
import repro.core.tger as jtger
import repro.data.generators as jgen
import repro.engine.plan as jplan
import repro_torch.core.temporal_graph as ttg
import repro_torch.core.tger as ttger
import repro_torch.data.generators as tgen
import repro_torch.engine.plan as tplan

CPU = "cpu"

# The port's tests run small tensors; torch's intra-op threads would only
# contend with the other test workers (xdist) for the cores.
torch.set_num_threads(1)

# the {scan, index, hybrid} x {xla_segment, pallas_tiled} plan cells
CELLS = [(a, b) for a in ("scan", "index", "hybrid")
         for b in ("xla_segment", "pallas_tiled")]

GRAPHS = {
    "power_law": ("power_law_temporal_graph", dict(n_vertices=300, n_edges=3000, seed=21)),
    "transit": ("transit_temporal_graph", dict(n_vertices=200, n_edges=2400, seed=22,
                                                headway=300)),
}


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


def _field_values(x):
    """A dataclass as the tuple of its field values, nested ones too, as
    ``dataclasses.astuple`` makes it."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(_field_values(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(map(_field_values, x))
    return x


def _assert_values_equal(want, got, where):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_values_equal(a, b, f"{where}[{i}]")
    elif want is None or isinstance(want, str):
        assert got == want, (where, want, got)
    else:
        a, b = as_np(want), as_np(got)
        assert a.shape == b.shape, where
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7, err_msg=where)
        else:
            assert (a == b).all(), where


def assert_astuple_in_reference_order(ref, port):
    """``dataclasses.astuple(port)`` begins with the reference's fields in
    the reference's ``fields()`` order, each value equal to the reference's
    (integers exactly, floats within rtol 1e-5 / atol 1e-7); the port may
    add fields after them."""
    names = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(port)][:len(names)] == names
    got = dataclasses.astuple(port)[:len(names)]
    want = _field_values(tuple(getattr(ref, n) for n in names))
    for name, a, b in zip(names, want, tuple(map(_field_values, got))):
        _assert_values_equal(a, b, name)


def graph_pair(kind, cutoff=48):
    """Both packages' generated graph of ``kind`` (see GRAPHS) and their TGER
    indexes: (jax graph, port graph, jax index, port index)."""
    fn, kw = GRAPHS[kind]
    jg = getattr(jgen, fn)(**kw)
    tg = getattr(tgen, fn)(**kw, device=CPU)
    return jg, tg, jtger.build_tger(jg, degree_cutoff=cutoff), ttger.build_tger(
        tg, degree_cutoff=cutoff)


def query_setup(kind):
    """``graph_pair`` plus three windows (a wide suffix, the last span/50,
    the first half of the span) and two sources (the top out-degree vertex
    and the median one)."""
    jg, tg, ji, ti = graph_pair(kind)
    ts = np.asarray(jg.t_start)
    t_lo, t_hi = int(ts.min()), int(np.asarray(jg.t_end).max())
    span = t_hi - t_lo
    wins = [(int(np.quantile(ts, 0.3)), t_hi), (t_hi - span // 50, t_hi),
            (t_lo, t_lo + span // 2)]
    deg = np.asarray(jg.out_degree)
    sources = [int(np.argmax(deg)), int(np.argsort(deg)[len(deg) // 2])]
    return jg, tg, ji, ti, wins, sources


def plans(jg, tg, ji, ti, access, backend, **where):
    """Both packages' plans for one cell (``window=`` or ``windows=``);
    their cache keys agree."""
    jp = jplan.plan_query(jg, ji, access=access, backend=backend, **where)
    tp = tplan.plan_query(tg, ti, access=access, backend=backend, **where)
    assert jp.cache_key == tp.cache_key
    return jp, tp


def assert_same(want, got):
    """Exact equality of a result or a tuple of results, shapes included."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(want, got):
            assert_same(a, b)
        return
    a, b = np.asarray(want), as_np(got)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert (a == b).all()


@contextlib.contextmanager
def one_rank_group():
    """A gloo process group of world size 1 in this process (the port's
    ``mesh=1`` / ``(1, 1)`` paths run in-process on it), destroyed on exit
    so that no later test in the worker sees it."""
    with tempfile.TemporaryDirectory() as tmp:
        from repro_torch.distributed import init_process_group

        init_process_group(CPU, init_method="file://" + os.path.join(tmp, "store"),
                           world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()
