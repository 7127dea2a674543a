"""Temporal PageRank in the port against the JAX package and the numpy
oracle: the six {scan, index, hybrid} x {xla_segment, pallas_tiled} plan
cells on a power-law and a transit graph, single-window, batched and over a
prebuilt view.

Tolerance: rtol 1e-5 / atol 1e-7, the reference's own
(``tests/test_engine.py``).  No cell is bit-identical on the CPU, not even
``xla_segment``, whose sums are: XLA's CPU backend contracts the update
``(1 - d) / V + d * (agg + dangling)`` into a fused multiply-add, which
PyTorch rounds as two operations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.core.algorithms as jalg
import repro.engine.plan as jplan
import repro_torch.core.algorithms as talg
import repro_torch.engine.plan as tplan
from repro.core.edgemap import view_for_plan as jview
from repro.core.reference import temporal_pagerank_ref
from repro_torch.core.edgemap import view_for_plan as tview
from test_torch_common import CELLS, as_np, both_graphs, query_setup

TOL = dict(rtol=1e-5, atol=1e-7)
N_ITERS = 20


def _close(want, got):
    got = as_np(got)
    assert got.dtype == np.float32 and got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access,backend", CELLS)
def test_pagerank_plan_cells(kind, access, backend):
    jg, tg, ji, ti, wins, _ = query_setup(kind)
    # single window (the wide suffix), under its own plan
    w = wins[0]
    jp = jplan.plan_query(jg, ji, w, access=access, backend=backend)
    tp = tplan.plan_query(tg, ti, w, access=access, backend=backend)
    assert jp.cache_key == tp.cache_key
    _close(jalg.temporal_pagerank(jg, w, ji, plan=jp, n_iters=N_ITERS),
           talg.temporal_pagerank(tg, w, ti, plan=tp, n_iters=N_ITERS))
    # all three windows batched under the union plan, and over a prebuilt view
    rows = np.asarray(wins, np.int32)
    jp = jplan.plan_query(jg, ji, windows=rows, access=access, backend=backend)
    tp = tplan.plan_query(tg, ti, windows=rows, access=access, backend=backend)
    assert jp.cache_key == tp.cache_key
    want = jalg.temporal_pagerank_batched(jg, rows, ji, plan=jp, n_iters=N_ITERS)
    got = talg.temporal_pagerank_batched(tg, rows, ti, plan=tp, n_iters=N_ITERS)
    _close(want, got)
    union = (int(rows[:, 0].min()), int(rows[:, 1].max()))
    over = talg.temporal_pagerank_over_view(
        tview(tg, ti, union, tp), rows, plan=tp, n_vertices=tg.n_vertices,
        n_iters=N_ITERS)
    assert torch.equal(over, got)
    # row w of the batch is the single-window run under the same plan
    for i, win in enumerate(wins):
        assert torch.equal(got[i], talg.temporal_pagerank(tg, win, ti, plan=tp,
                                                          n_iters=N_ITERS))


def test_pagerank_over_view_matches_jax_and_checks_arguments():
    jg, tg, ji, ti, wins, _ = query_setup("power_law")
    rows = np.asarray([wins[1], wins[0]], np.int32)
    jp = jplan.plan_query(jg, ji, windows=rows, access="scan", backend="pallas_tiled")
    tp = tplan.plan_query(tg, ti, windows=rows, access="scan", backend="pallas_tiled")
    union = (int(rows[:, 0].min()), int(rows[:, 1].max()))
    jedges, tedges = jview(jg, ji, union, jp), tview(tg, ti, union, tp)
    kw = dict(n_vertices=tg.n_vertices, n_iters=N_ITERS)
    want = jalg.temporal_pagerank_over_view(jedges, jnp.asarray(rows), plan=jp, **kw)
    got = talg.temporal_pagerank_over_view(tedges, rows, plan=tp, **kw)
    _close(want, got)
    # a warm start from a converged answer stays (nearly) put
    init = np.array(want)
    _close(jalg.temporal_pagerank_over_view(jedges, jnp.asarray(rows), plan=jp,
                                            init=jnp.asarray(init), **kw),
           talg.temporal_pagerank_over_view(tedges, rows, plan=tp,
                                            init=torch.as_tensor(init), **kw))
    with pytest.raises(ValueError, match="source-free"):
        talg.temporal_pagerank_over_view(tedges, rows, plan=tp, sources=0, **kw)


@pytest.mark.parametrize("damping,n_iters", [(0.85, 40), (0.5, 7)])
def test_pagerank_matches_numpy_oracle(damping, n_iters):
    """The golden check: the float64 oracle of ``core/reference.py`` on the
    port's own graph (its edge fields are plain CPU tensors)."""
    _, tg, _, ti, wins, _ = query_setup("transit")
    for w in wins:
        ref = temporal_pagerank_ref(tg, w, damping=damping, n_iters=n_iters)
        for backend in ("xla_segment", "pallas_tiled"):
            tp = tplan.plan_query(tg, ti, w, access="scan", backend=backend)
            got = talg.temporal_pagerank(tg, w, ti, plan=tp, damping=damping,
                                         n_iters=n_iters)
            np.testing.assert_allclose(as_np(got), ref, **TOL)


def test_pagerank_edgeless_and_dangling():
    """No valid edge: every vertex dangles, the rank stays uniform."""
    jg, tg = both_graphs(np.array([0, 1]), np.array([1, 2]), np.array([5, 6]),
                         np.array([6, 7]), n_vertices=4)
    for backend in ("xla_segment", "pallas_tiled"):
        tp = tplan.plan_query(tg, None, (100, 200), backend=backend)
        got = talg.temporal_pagerank(tg, (100, 200), plan=tp, n_iters=5)
        _close(jalg.temporal_pagerank(jg, (100, 200), n_iters=5), got)
        np.testing.assert_allclose(as_np(got), np.full(4, 0.25), rtol=1e-6)
