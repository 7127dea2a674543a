"""End-to-end invariants of the port's Kairos flow (build -> index ->
plan -> execute), mirroring ``test_system.py``: the selective window plans
the index path and the broad one the scan, each EA equal to the JAX
package's numpy oracle (``repro/core/reference.py``) and to the JAX
result; widening a window only lowers arrivals; PageRank conserves its
mass (and matches the JAX iteration within rtol 1e-5 / atol 1e-7); the
strict predicate forbids zero-wait chains."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.algorithms as jalg
import repro.core.reference as R
import repro.core.tger as jtger
import repro.data.generators as jgen
import repro.engine as jengine
import repro_torch.core.algorithms as talg
import repro_torch.data.generators as tgen
import repro_torch.engine as tengine
from repro.core.selective import CostModel as JCost
from repro.core.temporal_graph import from_edges as jfrom
from repro_torch.core.predicates import OrderingPredicateType as T
from repro_torch.core.selective import CostModel
from repro_torch.core.temporal_graph import from_edges
from repro_torch.core.tger import build_tger
from test_torch_common import CPU, as_np

INF = np.iinfo(np.int32).max


def _flow(seed, q=None):
    jg = jgen.power_law_temporal_graph(200, 8000, seed=seed)
    g = tgen.power_law_temporal_graph(200, 8000, seed=seed, device=CPU)
    idx = build_tger(g, degree_cutoff=64)
    ts = as_np(g.t_start)
    lo = int(ts.min()) if q is None else int(np.quantile(ts, q))
    return jg, g, idx, (lo, int(as_np(g.t_end).max()))


def test_full_kairos_flow_selective_window():
    """Load -> TGER build -> cost-model plan -> index-path EA == oracle."""
    jg, g, idx, window = _flow(21, q=0.97)
    dec = tengine.decision_for(g, idx, window, CostModel())
    assert dec.method == "index", "a 3% window on bursty data must choose TGER"
    jdec = jengine.decision_for(jg, jtger.build_tger(jg, degree_cutoff=64), window,
                                JCost())
    assert dec.__dict__ == jdec.__dict__
    src = int(np.argmax(as_np(g.out_degree)))
    got = talg.earliest_arrival(g, src, window, idx,
                                plan=tengine.make_plan(dec.method, budget=dec.budget))
    assert (as_np(got) == R.earliest_arrival_ref(jg, src, window)).all()


def test_full_kairos_flow_broad_window():
    jg, g, idx, window = _flow(22)
    dec = tengine.decision_for(g, idx, window, CostModel())
    assert dec.method == "scan", "a full-range window must scan"
    src = int(as_np(g.src)[0])
    got = talg.earliest_arrival(g, src, window)
    assert (as_np(got) == R.earliest_arrival_ref(jg, src, window)).all()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 500))
def test_ea_monotonicity_property(seed):
    """Widening the window can only improve (lower) arrival times."""
    rng = np.random.default_rng(seed)
    n_v, n_e = 25, 150
    src_a, dst_a = rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e)
    ts = rng.integers(0, 100, n_e)
    te = ts + rng.integers(0, 10, n_e)
    g = from_edges(src_a, dst_a, ts, te, n_vertices=n_v, device=CPU)
    s = int(src_a[0])
    narrow = as_np(talg.earliest_arrival(g, s, (40, 90)))
    wide = as_np(talg.earliest_arrival(g, s, (40, 120)))
    reachable = narrow < INF
    assert (wide[reachable] <= narrow[reachable]).all()
    jg = jfrom(src_a, dst_a, ts, te, n_vertices=n_v)
    assert (np.asarray(jalg.earliest_arrival(jg, s, (40, 120))) == wide).all()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 500))
def test_pagerank_mass_conservation(seed):
    rng = np.random.default_rng(seed)
    n_v, n_e = 30, 200
    edges = (rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e),
             rng.integers(0, 100, n_e))
    g = from_edges(*edges, None, n_vertices=n_v, rng=np.random.default_rng(seed),
                   device=CPU)
    pr = as_np(talg.temporal_pagerank(g, (0, 10_000), n_iters=80))
    assert pr.sum() == pytest.approx(1.0, rel=1e-3)
    assert (pr > 0).all()
    jg = jfrom(*edges, None, n_vertices=n_v, rng=np.random.default_rng(seed))
    np.testing.assert_allclose(
        pr, np.asarray(jalg.temporal_pagerank(jg, (0, 10_000), n_iters=80)),
        rtol=1e-5, atol=1e-7)


def test_ea_respects_strictness():
    """Zero-wait chains allowed by SUCCEEDS, forbidden by STRICTLY."""
    # 0 -(t 1..2)-> 1 -(t 2..3)-> 2 : the second edge starts at the arrival
    g = from_edges([0, 1], [1, 2], [1, 2], [2, 3], n_vertices=3, device=CPU)
    weak = as_np(talg.earliest_arrival(g, 0, (0, 10), pred=T.SUCCEEDS))
    strict = as_np(talg.earliest_arrival(g, 0, (0, 10), pred=T.STRICTLY_SUCCEEDS))
    assert weak[2] == 3
    assert strict[2] == INF
    assert isinstance(talg.earliest_arrival(g, 0, (0, 10)), torch.Tensor)
