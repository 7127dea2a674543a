"""Temporal betweenness in the port against the JAX package in the six plan
cells (single, batched, over a prebuilt view with per-row sources), and its
arrival-bucket bounds pinned bit for bit.

Tolerance: rtol 1e-5 / atol 1e-7 — betweenness is a float accumulation.
The bucket bounds are float32 arithmetic truncated to int32; a bound one
off re-buckets vertices, so they are held to exact equality.  The JAX
program is compiled, and XLA turns its division by the bucket count into a
multiplication by the count's float32 reciprocal: for a count that is not a
power of two that rounds differently from a true division (7, 100 below).
"""
import jax
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
from repro_torch.core.algorithms.centrality import bucket_bounds
from repro_torch.core.edgemap import view_for_plan as tview
from test_torch_common import CELLS, as_np, query_setup

TOL = dict(rtol=1e-5, atol=1e-7)


def _close(want, got):
    got = as_np(got)
    assert got.dtype == np.float32 and got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("n_buckets", [7, 64, 100, 512])
def test_bucket_bounds_bit_identical(n_buckets):
    """The JAX expression of ``centrality.py::_brandes_row``, jitted and
    vmapped over rows as there, against the port's, on windows up to the
    int32 time range the generators use."""
    rng = np.random.default_rng(n_buckets)
    ta = rng.integers(-1000, 2_000_000, 400)
    wins = np.stack([ta, ta + rng.integers(0, 50_000_000, 400)], 1).astype(np.int32)
    wins[:4] = [[0, 0], [0, 1], [5, 5 + n_buckets - 1], [0, 2**30]]

    def bounds(w):
        ta, tb = w[0], w[1]
        P = n_buckets
        return ta + ((tb - ta).astype(jnp.float32) * (jnp.arange(P) + 1) / P
                     ).astype(jnp.int32)

    want = np.asarray(jax.jit(jax.vmap(bounds))(jnp.asarray(wins)))
    got = bucket_bounds(torch.as_tensor(wins), n_buckets)
    assert got.dtype == torch.int32
    assert (as_np(got) == want).all()


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access,backend", CELLS)
def test_betweenness_plan_cells(kind, access, backend):
    jg, tg, ji, ti, wins, sources = query_setup(kind)
    w = wins[0]
    jp = jplan.plan_query(jg, ji, w, access=access, backend=backend)
    tp = tplan.plan_query(tg, ti, w, access=access, backend=backend)
    _close(jalg.temporal_betweenness(jg, sources, w, ji, plan=jp),
           talg.temporal_betweenness(tg, sources, w, ti, plan=tp))
    rows_w = np.asarray([wins[0], wins[1], wins[0]], np.int32)
    jp = jplan.plan_query(jg, ji, windows=rows_w, access=access, backend=backend)
    tp = tplan.plan_query(tg, ti, windows=rows_w, access=access, backend=backend)
    _close(jalg.temporal_betweenness_batched(jg, sources[0], rows_w, ji, plan=jp),
           talg.temporal_betweenness_batched(tg, sources[0], rows_w, ti, plan=tp))
    rows_s = np.asarray([sources[0], sources[1], sources[1]], np.int32)
    union = (int(rows_w[:, 0].min()), int(rows_w[:, 1].max()))
    _close(jalg.temporal_betweenness_over_view(
               jview(jg, ji, union, jp), jnp.asarray(rows_w), plan=jp,
               n_vertices=jg.n_vertices, sources=jnp.asarray(rows_s), n_buckets=16),
           talg.temporal_betweenness_over_view(
               tview(tg, ti, union, tp), rows_w, plan=tp, n_vertices=tg.n_vertices,
               sources=rows_s, n_buckets=16))


def test_betweenness_argument_checks():
    _, tg, _, ti, wins, _ = query_setup("transit")
    rows = np.asarray(wins, np.int32)
    tp = tplan.plan_query(tg, ti, windows=rows, access="scan")
    edges = tview(tg, ti, (int(rows[:, 0].min()), int(rows[:, 1].max())), tp)
    kw = dict(plan=tp, n_vertices=tg.n_vertices)
    with pytest.raises(ValueError, match="needs sources"):
        talg.temporal_betweenness_over_view(edges, rows, **kw)
    with pytest.raises(ValueError, match="warm init"):
        talg.temporal_betweenness_over_view(edges, rows, sources=0, init=rows, **kw)
