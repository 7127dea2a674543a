"""The port's graph model, generators and TGER index against the JAX
package, built from the same numpy inputs; every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.histogram as jhist
import repro.core.predicates as jpred
import repro.core.tger as jtger
import repro.data.generators as jgen
import repro_torch.core.histogram as thist
import repro_torch.core.predicates as tpred
import repro_torch.core.temporal_graph as ttg
import repro_torch.core.tger as ttger
import repro_torch.data.generators as tgen
from test_torch_common import (CPU, as_np, assert_astuple_in_reference_order,
                               assert_fields_equal, both_graphs, random_edges)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_end", [True, False])
def test_from_edges_fields(seed, with_end):
    src, dst, ts, te = random_edges(60, 900, seed)
    jg, tg = both_graphs(src, dst, ts, te if with_end else None)
    assert_fields_equal(jg, tg)
    assert all(t.device.type == "cpu" for t in (tg.src, tg.in_perm, tg.weight))
    assert (as_np(tg.out_degree) == np.asarray(jg.out_degree)).all()
    assert (as_np(tg.in_degree) == np.asarray(jg.in_degree)).all()
    for a, b in zip(jg.in_edge_fields(), tg.in_edge_fields()):
        assert (np.asarray(a) == as_np(b)).all()
    ttg.validate(tg)


def test_from_edges_explicit_vertex_count_and_empty():
    jg, tg = both_graphs(np.array([0, 3]), np.array([3, 1]), np.array([5, 2]),
                         np.array([9, 4]), n_vertices=10)
    assert_fields_equal(jg, tg)
    e = np.zeros(0, np.int64)
    jg, tg = both_graphs(e, e, e, e, n_vertices=4)
    assert_fields_equal(jg, tg)
    assert tg.n_edges == 0 and as_np(tg.out_offsets).tolist() == [0] * 5


def test_validate_rejects_broken_graph():
    _, tg = both_graphs(*random_edges(20, 100, 3))
    bad = ttg.TemporalGraph(**{**tg.__dict__, "t_end": tg.t_start - 1})
    with pytest.raises(ValueError):
        ttg.validate(bad)


@pytest.mark.parametrize("name,kw", [
    ("synthetic_temporal_graph", dict(n_vertices=120, n_edges=2000, seed=4)),
    ("synthetic_temporal_graph", dict(n_vertices=50, n_edges=700, seed=5, weighted=True)),
    ("power_law_temporal_graph", dict(n_vertices=300, n_edges=5000, seed=6)),
    ("power_law_temporal_graph", dict(n_vertices=80, n_edges=900, seed=7, weighted=True)),
    ("transit_temporal_graph", dict(n_vertices=200, n_edges=3000, seed=8, k=2)),
    ("transit_temporal_graph", dict(n_vertices=90, n_edges=600, seed=9, weighted=True)),
])
def test_generators_same_edges(name, kw):
    jg = getattr(jgen, name)(**kw)
    tg = getattr(tgen, name)(**kw, device=CPU)
    assert_fields_equal(jg, tg)


@pytest.mark.parametrize("cutoff,in_edges", [(64, False), (32, True), (10**6, False)])
def test_build_tger_fields(cutoff, in_edges):
    jg = jgen.power_law_temporal_graph(300, 6000, seed=11)
    tg = tgen.power_law_temporal_graph(300, 6000, seed=11, device=CPU)
    ji = jtger.build_tger(jg, degree_cutoff=cutoff, index_in_edges=in_edges)
    ti = ttger.build_tger(tg, degree_cutoff=cutoff, index_in_edges=in_edges)
    assert_fields_equal(ji, ti)
    assert ti.perm_by_start.device.type == "cpu"


@pytest.mark.parametrize("cutoff,in_edges", [(64, False), (32, True), (10**6, False)])
def test_tger_astuple_in_reference_order(cutoff, in_edges):
    """Positional views of the index (``astuple``) line up with the JAX
    package's fields."""
    jg = jgen.power_law_temporal_graph(200, 3000, seed=13)
    tg = tgen.power_law_temporal_graph(200, 3000, seed=13, device=CPU)
    assert_astuple_in_reference_order(
        jtger.build_tger(jg, degree_cutoff=cutoff, index_in_edges=in_edges),
        ttger.build_tger(tg, degree_cutoff=cutoff, index_in_edges=in_edges))


def _graph_and_index(seed=12, cutoff=48):
    jg = jgen.power_law_temporal_graph(200, 4000, seed=seed)
    tg = tgen.power_law_temporal_graph(200, 4000, seed=seed, device=CPU)
    return jg, tg, jtger.build_tger(jg, degree_cutoff=cutoff), ttger.build_tger(
        tg, degree_cutoff=cutoff)


def _windows(jg, n=12):
    ts = np.asarray(jg.t_start)
    t_lo, t_hi = int(ts.min()), int(np.asarray(jg.t_end).max())
    span = t_hi - t_lo
    qs = np.linspace(0.0, 0.99, n)
    wins = [(int(np.quantile(ts, q)), t_hi) for q in qs]
    wins += [(t_hi - span // 50, t_hi), (t_lo, t_lo + span // 3), (t_hi + 5, t_hi + 9)]
    return wins


def test_window_range_and_host_positions():
    jg, tg, ji, ti = _graph_and_index()
    for w in _windows(jg):
        lo, hi = jtger.window_range(ji, *w)
        tlo, thi = ttger.window_range(ti, *w)
        assert (int(lo), int(hi)) == (int(tlo), int(thi))
        assert jtger.window_positions_host(ji, w) == ttger.window_positions_host(ti, w)
        assert (jtger.heavy_window_positions_host(ji, w)
                == ttger.heavy_window_positions_host(ti, w))
        je, jp = jtger.gather_window_edges(ji, lo, 256)
        te_, tp = ttger.gather_window_edges(ti, tlo, 256)
        assert (np.asarray(je) == as_np(te_)).all() and (np.asarray(jp) == as_np(tp)).all()


def test_vertex_range_and_bounded_searchsorted():
    jg, tg, ji, ti = _graph_and_index()
    v = np.arange(jg.n_vertices)
    for w in _windows(jg, n=6):
        jlo, jhi = jtger.vertex_range(jg, v, w[0], w[1])
        tlo, thi = ttger.vertex_range(tg, torch.as_tensor(v), w[0], w[1])
        assert (np.asarray(jlo) == as_np(tlo)).all()
        assert (np.asarray(jhi) == as_np(thi)).all()
    rng = np.random.default_rng(0)
    arr = np.sort(rng.integers(0, 50, 300)).astype(np.int32)
    lo = rng.integers(0, 300, 64)
    hi = np.minimum(lo + rng.integers(0, 100, 64), 300)
    val = rng.integers(-5, 55, 64)
    for side in ("left", "right"):
        a = jtger.bounded_searchsorted(jnp.asarray(arr), lo, hi, val, side=side)
        b = ttger.bounded_searchsorted(torch.as_tensor(arr), lo, hi,
                                       torch.as_tensor(val), side=side)
        assert (np.asarray(a) == as_np(b)).all()


def test_histogram_estimate_bits():
    """The host float32 estimate equals the JAX estimate bit for bit."""
    jg, tg, ji, ti = _graph_and_index()
    for w in _windows(jg, n=20):
        a = np.float32(jhist.estimate_window(ji.global_hist, *w))
        b = thist.estimate_window(ti.global_hist, *w)
        assert a.tobytes() == np.float32(b).tobytes(), w
    for slot in range(ti.n_indexed):
        jh = jhist.Histogram2D(*(np.asarray(x)[slot] for x in (
            ji.vertex_hist.sat, ji.vertex_hist.start_edges, ji.vertex_hist.dur_edges)))
        th = thist.Histogram2D(ti.vertex_hist.sat[slot], ti.vertex_hist.start_edges[slot],
                               ti.vertex_hist.dur_edges[slot])
        for w in _windows(jg, n=5):
            assert np.float32(jhist.estimate_window(jh, *w)) == thist.estimate_window(th, *w)


def test_predicates():
    rng = np.random.default_rng(1)
    a, s, e, s0 = (rng.integers(0, 20, 50) for _ in range(4))
    for pred in ("SUCCEEDS", "STRICTLY_SUCCEEDS", "OVERLAPS"):
        j = jpred.edge_follows(jpred.OrderingPredicateType[pred], a, s, e, src_start=s0)
        t = tpred.edge_follows(tpred.OrderingPredicateType[pred], torch.as_tensor(a),
                               torch.as_tensor(s), torch.as_tensor(e),
                               src_start=torch.as_tensor(s0))
        assert (np.asarray(j) == as_np(t)).all()
    assert (np.asarray(jpred.in_window(s, e, 5, 15))
            == as_np(tpred.in_window(torch.as_tensor(s), torch.as_tensor(e), 5, 15))).all()
    with pytest.raises(ValueError):
        tpred.edge_follows(tpred.OrderingPredicateType.OVERLAPS, a, s, e)
