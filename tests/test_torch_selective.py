"""The port's selective-indexing cost model (``repro_torch.core.selective``,
paper §5, Eq. 1-3) against the JAX package's: the mirrors of
``test_selective.py`` on the port, and the per-vertex decisions equal to
the reference's bit for bit (``use_index`` and the float32 ``k_est``: both
compute each vertex's SAT estimate one float32 operation at a time in the
same order)."""
import dataclasses

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.core import selective as jsel
from repro.core.tger import build_tger as jbuild
from repro.data.generators import power_law_temporal_graph as jpower_law
from repro_torch.core import selective as tsel
from repro_torch.core.selective import (
    CostModel,
    budget_for,
    calibrate_constants,
    decide_access,
    per_vertex_decisions,
)
from repro_torch.core.tger import build_tger
from repro_torch.data.generators import power_law_temporal_graph


@pytest.fixture(scope="module")
def gi():
    g = power_law_temporal_graph(150, 6000, seed=4, device="cpu")
    return g, build_tger(g, degree_cutoff=32)


def test_selective_window_uses_index(gi):
    g, idx = gi
    ts = g.t_start.numpy()
    win = (int(np.quantile(ts, 0.98)), int(g.t_end.max()))
    dec = decide_access(idx, g.n_edges, win)
    assert dec.method == "index"
    assert dec.selectivity < 0.15


def test_broad_window_uses_scan(gi):
    g, idx = gi
    ts = g.t_start.numpy()
    win = (int(ts.min()), int(g.t_end.max()))
    dec = decide_access(idx, g.n_edges, win)
    assert dec.method == "scan"
    assert dec.selectivity > 0.5


def test_force_overrides(gi):
    g, idx = gi
    ts = g.t_start.numpy()
    win = (int(ts.min()), int(g.t_end.max()))
    dec = decide_access(idx, g.n_edges, win, force="index")
    # a full-window force degenerates back to scan via the budget cap
    assert dec.method in ("index", "scan")
    dec2 = decide_access(idx, g.n_edges, (int(np.quantile(ts, 0.99)), int(ts.max())),
                         force="scan")
    assert dec2.method == "scan"


def test_budget_ladder_is_pow2():
    m = CostModel()
    for k in (1, 63, 64, 100, 5000, 12345):
        b = budget_for(float(k), 1 << 20, m)
        assert b & (b - 1) == 0
        assert b >= min(k, 64)


def test_cost_model_crossover():
    """Eq. 3: index wins iff beta <= theta AND modeled cost is lower."""
    m = CostModel(c_index=5.0, c_scan=1.0, theta_sel=0.15)
    E = 100_000
    assert m.choose(E, k_est=1000) == "index"      # beta=0.01
    assert m.choose(E, k_est=50_000) == "scan"     # beta=0.5
    # beta under theta but modeled index cost exceeds the scan cost
    m_slow_index = CostModel(c_index=10.0, c_scan=1.0, theta_sel=0.15)
    assert m_slow_index.choose(E, k_est=E * 0.14) == "scan"


@pytest.mark.parametrize("kw", [{}, dict(max_budget_rungs=8, budget_slack=2.0)])
def test_cost_model_fields_equal_jax(kw):
    """The cost model's fields, ``max_budget_rungs`` among them (32; read by
    neither package), in the JAX package's order with its defaults;
    ``replace`` and equality behave alike."""
    j, t = jsel.CostModel(**kw), CostModel(**kw)
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert t.max_budget_rungs == j.max_budget_rungs == kw.get("max_budget_rungs", 32)
    assert (dataclasses.replace(t, max_budget_rungs=4) == t) == (
        dataclasses.replace(j, max_budget_rungs=4) == j)


def test_calibration():
    m = calibrate_constants(scan_time_per_edge=1e-9, index_time_per_edge=6e-9)
    assert m.c_index == pytest.approx(6.0)
    j = jsel.calibrate_constants(scan_time_per_edge=1e-9, index_time_per_edge=6e-9)
    assert (m.c_index, m.c_scan, m.theta_sel) == (j.c_index, j.c_scan, j.theta_sel)


def test_per_vertex_decisions(gi):
    g, idx = gi
    ts = g.t_start.numpy()
    win = (int(np.quantile(ts, 0.98)), int(g.t_end.max()))
    use_index, k_est = per_vertex_decisions(idx, g.out_degree, win)
    assert use_index.shape[0] == max(idx.n_indexed, 1)
    assert (k_est.numpy() >= 0).all()
    assert use_index.device == idx.indexed_ids.device


@pytest.mark.parametrize("seed,cutoff", [(4, 32), (5, 8), (6, 4000)])
def test_per_vertex_decisions_equal_jax(seed, cutoff):
    """On the mirrored graph (and one where many vertices are indexed, and
    one with none: the reference's one-slot placeholder), over 60 seeded
    windows, a reversed one and an empty one: ``use_index`` and ``k_est``
    equal JAX's bit for bit, and each ``k_est`` equals the port's scalar
    ``estimate_window`` of that vertex's histogram."""
    from repro_torch.core.histogram import Histogram2D, estimate_window

    jg = jpower_law(150, 6000, seed=seed)
    tg = power_law_temporal_graph(150, 6000, seed=seed, device="cpu")
    ji, ti = jbuild(jg, degree_cutoff=cutoff), build_tger(tg, degree_cutoff=cutoff)
    ts = np.asarray(jg.t_start)
    t_hi = int(np.asarray(jg.t_end).max())
    rng = np.random.default_rng(seed)
    wins = [(int(np.quantile(ts, 0.98)), t_hi), (t_hi, 0), (t_hi + 5, t_hi + 5)]
    wins += [tuple(sorted(rng.integers(0, t_hi + 100, 2).tolist())) for _ in range(60)]
    model = CostModel(c_index=3.0, theta_sel=0.3)
    jmodel = jsel.CostModel(c_index=3.0, theta_sel=0.3)
    flips = 0
    for w in wins:
        for tm, jm in ((CostModel(), jsel.CostModel()), (model, jmodel)):
            ju, jk = jsel.per_vertex_decisions(ji, jg.out_degree, w, jm)
            tu, tk = per_vertex_decisions(ti, tg.out_degree, w, tm)
            np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
            flips += int(tu.any()) != int(tu.all())
    vh = ti.vertex_hist
    for h in range(vh.sat.shape[0]):
        one = Histogram2D(vh.sat[h], vh.start_edges[h], vh.dur_edges[h])
        _, tk = per_vertex_decisions(ti, tg.out_degree, wins[0])
        assert tk.numpy()[h] == estimate_window(one, *wins[0])
    assert tsel.__all__ == jsel.__all__
    if cutoff < 100:
        assert flips > 0  # some windows split the vertices between the paths
