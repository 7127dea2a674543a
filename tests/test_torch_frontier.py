"""The port's frontier-rung ladder (``repro_torch.engine.frontier``) against
the JAX package's (``test_frontier.py``, for results):

1. the laddered-vs-dense matrix: seven algorithms x {scan, index, hybrid}
   (and scan/pallas_tiled for EA and CC): a laddered solve equals the
   port's dense solve bit for bit and the JAX package's laddered solve
   (integers exactly, PageRank and betweenness within rtol 1e-5 / atol
   1e-7, the JAX tests' tolerance), its ``segments`` record equal to the
   JAX record; ``with_rounds``, the warm init, ``visit_once`` (dense);
2. where the ladder engages: host-level ``*_over_view`` calls and the
   serving cold solves, never ``earliest_arrival``, a ``*_batched`` entry
   point, ``sweep`` or a serving advance (as in the JAX package, which
   traces those);
3. the companion view (hypothesis): equal to the JAX companion, canonical,
   delta-advanced equal to a rebuild, ring wrap-around included;
4. ``choose_rungs`` monotone and equal to the JAX rungs;
5. ``frontier_trace`` against a host oracle and the JAX trace.

The JAX tests' ``ladder_trace_count`` pinning counts jit traces, which
eager torch does not have; the ``segments`` record stands in for it.
A spy wraps ``run_laddered`` in each algorithm module to read the record
of calls made through the public entry points."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.edgemap as jem
import repro.core.temporal_graph as jtg
import repro.core.tger as jtger
import repro.engine.frontier as jfr
import repro.engine.plan as jplan
import repro.serve.window_sweep as jws
from repro.core.algorithms import bfs as jbfs
from repro.core.algorithms import centrality as jcent
from repro.core.algorithms import connectivity as jcc
from repro.core.algorithms import kcore as jkc
from repro.core.algorithms import pagerank as jpr
from repro.core.algorithms import paths as jpaths
from repro.core.algorithms import reachability as jreach
from repro.core.predicates import OrderingPredicateType as JT
from repro.engine.fixpoint import FixpointRunner as JRunner
import repro_torch.core.edgemap as tem
import repro_torch.core.temporal_graph as ttg
import repro_torch.core.tger as ttger
import repro_torch.engine.backends as tbackends
import repro_torch.engine.frontier as tfr
import repro_torch.engine.plan as tplan
import repro_torch.serve.window_sweep as tws
from repro_torch.core.algorithms import bfs as tbfs
from repro_torch.core.algorithms import centrality as tcent
from repro_torch.core.algorithms import connectivity as tcc
from repro_torch.core.algorithms import kcore as tkc
from repro_torch.core.algorithms import pagerank as tpr
from repro_torch.core.algorithms import paths as tpaths
from repro_torch.core.algorithms import reachability as treach
from repro_torch.core.predicates import OrderingPredicateType as TT
from repro_torch.engine.fixpoint import FixpointRunner
from repro_torch.engine.queries import QueryBatch, QuerySpec
from test_torch_common import CPU, as_np

T_MAX = 1000
TOL = dict(rtol=1e-5, atol=1e-7)
_WINDOWS = np.asarray([[0, 400], [150, 520], [300, 700]], np.int32)
_SRCS = np.asarray([1, 5, 9], np.int32)
_CACHE = {}

_T_MODULES = (tpaths, tbfs, tcc, tkc, treach)
_J_MODULES = (jpaths, jbfs, jcc, jkc, jreach)


def _graph(seed, n_v=40, n_e=600):
    """Both packages' graph and TGER from one seeded edge list (the JAX
    tests' ``_graph``)."""
    key = (seed, n_v, n_e)
    if key not in _CACHE:
        rng = np.random.default_rng(seed)
        src, dst = rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e)
        ts = rng.integers(0, T_MAX, n_e)
        jg = jtg.from_edges(src, dst, ts, None, n_vertices=n_v,
                            rng=np.random.default_rng(seed))
        tg = ttg.from_edges(src, dst, ts, None, n_vertices=n_v,
                            rng=np.random.default_rng(seed), device=CPU)
        _CACHE[key] = (jg, tg, jtger.build_tger(jg, degree_cutoff=8, n_time_buckets=8),
                       ttger.build_tger(tg, degree_cutoff=8, n_time_buckets=8))
    return _CACHE[key]


def _views(access, ladder, backend="xla_segment", seed=0, **graph_kw):
    """Both packages' union plan and view over ``_WINDOWS``."""
    jg, tg, ji, ti = _graph(seed, **graph_kw)
    jp = jplan.plan_query(jg, ji, windows=_WINDOWS, access=access, backend=backend,
                          ladder=ladder)
    tp = tplan.plan_query(tg, ti, windows=_WINDOWS, access=access, backend=backend,
                          ladder=ladder)
    assert jp.cache_key == tp.cache_key
    je = jem.view_for_plan(jg, ji, jem.union_window(_WINDOWS), jp)
    te = tem.view_for_plan(tg, ti, tem.union_window(_WINDOWS), tp)
    return (jg, je, jp), (tg, te, tp)


def _port_view(jfv) -> tfr.FrontierView:
    """A JAX companion as the port's (numpy in between)."""
    return tfr.FrontierView(*(torch.as_tensor(np.array(a)) for a in jfv))


def _assert_close(want, got, exact=True):
    if isinstance(want, tuple):
        for a, b in zip(want, got):
            _assert_close(a, b, exact)
        return
    a, b = np.asarray(want), as_np(got)
    assert a.shape == b.shape
    if exact:
        assert (a == b).all()
    else:
        np.testing.assert_allclose(b, a, **TOL)


def _bit_equal(a, b):
    if isinstance(a, tuple):
        return all(_bit_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _spy(record, inner):
    def spy(*args, segments=None, **kw):
        segs = [] if segments is None else segments
        out = inner(*args, segments=segs, **kw)
        record.append(segs)
        return out

    return spy


@pytest.fixture
def ladder_calls(monkeypatch):
    """The ``segments`` record of every port laddered solve, in call order."""
    calls = []
    for mod in _T_MODULES:
        monkeypatch.setattr(mod, "run_laddered", _spy(calls, tfr.run_laddered))
    return calls


@pytest.fixture
def jax_ladder_calls(monkeypatch):
    calls = []
    for mod in _J_MODULES:
        monkeypatch.setattr(mod, "run_laddered", _spy(calls, jfr.run_laddered))
    return calls


# (JAX entry, port entry, keyword arguments, exact)
_ALGS = {
    "ea": (jpaths.earliest_arrival_over_view, tpaths.earliest_arrival_over_view,
           dict(sources=_SRCS), True),
    "bfs": (jbfs.temporal_bfs_over_view, tbfs.temporal_bfs_over_view,
            dict(sources=_SRCS), True),
    "reach": (jreach.overlaps_reachability_over_view,
              treach.overlaps_reachability_over_view, dict(sources=_SRCS), True),
    "cc": (jcc.temporal_cc_over_view, tcc.temporal_cc_over_view, {}, True),
    "kcore": (jkc.temporal_kcore_over_view, tkc.temporal_kcore_over_view,
              dict(k=2), True),
    "pagerank": (jpr.temporal_pagerank_over_view, tpr.temporal_pagerank_over_view,
                 dict(n_iters=4), False),
    "betweenness": (jcent.temporal_betweenness_over_view,
                    tcent.temporal_betweenness_over_view,
                    dict(sources=_SRCS, n_buckets=16), False),
}


# ---------------------------------------------------------------------------
# 1. laddered == dense == the JAX laddered solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", list(_ALGS))
@pytest.mark.parametrize("access", ["scan", "index", "hybrid"])
def test_laddered_matches_dense_matrix(access, alg, ladder_calls, jax_ladder_calls):
    jfn, tfn, kw, exact = _ALGS[alg]
    (_, je, jp), (tg, te, tp) = _views(access, 32)
    _, (_, te_d, tp_d) = _views(access, 0)
    V = tg.n_vertices
    want = jfn(je, _WINDOWS, plan=jp, n_vertices=V, **kw)
    dense = tfn(te_d, _WINDOWS, plan=tp_d, n_vertices=V, **kw)
    assert not ladder_calls
    got = tfn(te, _WINDOWS, plan=tp, n_vertices=V, **kw)
    assert _bit_equal(got, dense)
    _assert_close(want if isinstance(want, tuple) else np.asarray(want), got, exact)
    # PageRank is the documented no-op; the others ran the ladder, and
    # their segments equal the JAX package's
    assert len(ladder_calls) == (0 if alg == "pagerank" else 1)
    assert ladder_calls == jax_ladder_calls


@pytest.mark.parametrize("alg", ["ea", "cc"])
def test_laddered_tiled_scan_runs_k1_in_dense_segments(alg, monkeypatch, ladder_calls):
    """On scan/pallas_tiled the ladder's dense segments run the algorithm's
    own combine, K1 (its plain version here, counted through the backend's
    binding): laddered == dense == the JAX laddered result."""
    jfn, tfn, kw, _ = _ALGS[alg]
    graph = dict(seed=2, n_v=64, n_e=1200)
    (_, je, jp), _ = _views("scan", 64, **graph)
    _, (tg, te, tp) = _views("scan", 64, backend="pallas_tiled", **graph)
    _, (_, te_d, tp_d) = _views("scan", 0, backend="pallas_tiled", **graph)
    V = tg.n_vertices
    dense = tfn(te_d, _WINDOWS, plan=tp_d, n_vertices=V, **kw)
    k1 = []
    inner = tbackends.segment_min_tiles

    def counted(*args, **kwargs):
        k1.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(tbackends, "segment_min_tiles", counted)
    got = tfn(te, _WINDOWS, plan=tp, n_vertices=V, **kw)
    assert torch.equal(got, dense)
    _assert_close(np.asarray(jfn(je, _WINDOWS, plan=jp, n_vertices=V, **kw)), got)
    # one K1 launch per dense round (all windows in one), none in a sparse one
    (segs,) = ladder_calls
    dense_rounds = sum(n for kind, _, _, n in segs if kind == "dense")
    assert dense_rounds > 0 and len(k1) == dense_rounds


@pytest.mark.parametrize("alg", ["bfs", "reach", "cc", "kcore"])
def test_dense_rounds_build_hoisted_state_once(alg, monkeypatch, ladder_calls):
    """A laddered solve's dense rounds (one ``dense_round`` call each) reuse
    what the runner hoists: each ``FixpointRunner.hoisted`` entry is built
    once per runner, however many dense rounds run."""
    builds = []
    inner = FixpointRunner.hoisted

    def counted(self, key, build):
        def record():
            builds.append((id(self), key))
            return build()
        return inner(self, key, record)

    monkeypatch.setattr(FixpointRunner, "hoisted", counted)
    _, tfn, kw, _ = _ALGS[alg]
    # a cap of 2 and k = 12 keep several rounds dense on this graph
    kw = dict(kw, k=12) if alg == "kcore" else kw
    _, (tg, te, tp) = _views("scan", 2, seed=2, n_v=64, n_e=1200)
    tfn(te, _WINDOWS, plan=tp, n_vertices=tg.n_vertices, **kw)
    (segs,) = ladder_calls
    dense_rounds = sum(n for kind, *_, n in segs if kind == "dense")
    assert 0 < len(builds) < dense_rounds and len(builds) == len(set(builds))


def test_laddered_with_rounds_and_warm_init(ladder_calls):
    (_, je, jp), (tg, te, tp) = _views("index", 32)
    _, (_, te_d, tp_d) = _views("index", 0)
    V = tg.n_vertices
    a_d, r_d = tpaths.earliest_arrival_over_view(te_d, _WINDOWS, plan=tp_d, n_vertices=V,
                                                 sources=_SRCS, with_rounds=True)
    a_l, r_l = tpaths.earliest_arrival_over_view(te, _WINDOWS, plan=tp, n_vertices=V,
                                                 sources=_SRCS, with_rounds=True)
    j_a, j_r = jpaths.earliest_arrival_over_view(je, _WINDOWS, plan=jp, n_vertices=V,
                                                 sources=_SRCS, with_rounds=True)
    assert torch.equal(a_d, a_l) and r_d == r_l == int(j_r)
    _assert_close(np.asarray(j_a), a_l)
    assert r_l == sum(n for *_, n in ladder_calls[0])
    # a warm start from the converged labels is a fixpoint no-op on both
    a_d2 = tpaths.earliest_arrival_over_view(te_d, _WINDOWS, plan=tp_d, n_vertices=V,
                                             init=a_d)
    a_l2 = tpaths.earliest_arrival_over_view(te, _WINDOWS, plan=tp, n_vertices=V,
                                             init=a_l)
    assert torch.equal(a_d2, a_d) and torch.equal(a_l2, a_l)
    assert len(ladder_calls) == 2


def test_visit_once_stays_dense(ladder_calls):
    _, (tg, te, tp) = _views("scan", 32)
    _, (_, te_d, tp_d) = _views("scan", 0)
    kw = dict(n_vertices=tg.n_vertices, sources=np.asarray([2, 3, 4], np.int32),
              visit_once=True)
    got = tpaths.earliest_arrival_over_view(te, _WINDOWS, plan=tp, **kw)
    assert ladder_calls == []
    assert torch.equal(got, tpaths.earliest_arrival_over_view(te_d, _WINDOWS, plan=tp_d,
                                                              **kw))


@pytest.mark.parametrize("alg", ["ea", "bfs", "reach", "cc", "kcore"])
def test_segment_record_equals_jax(alg, ladder_calls, jax_ladder_calls):
    """On a denser graph whose frontiers rise and collapse: the segment
    sequence (dense prefix, sparse rungs, overflow re-entries) equals the
    JAX package's; sparse rungs are pow2 and every segment ran a round;
    the rounds sum to the global count."""
    jfn, tfn, kw, _ = _ALGS[alg]
    (_, je, jp), (tg, te, tp) = _views("scan", 64, seed=2, n_v=64, n_e=1200)
    _, (_, te_d, tp_d) = _views("scan", 0, seed=2, n_v=64, n_e=1200)
    V = tg.n_vertices
    want = jfn(je, _WINDOWS, plan=jp, n_vertices=V, **kw)
    got = tfn(te, _WINDOWS, plan=tp, n_vertices=V, **kw)
    assert _bit_equal(got, tfn(te_d, _WINDOWS, plan=tp_d, n_vertices=V, **kw))
    _assert_close(want if isinstance(want, tuple) else np.asarray(want), got)
    (segs,) = ladder_calls
    assert segs == jax_ladder_calls[0]
    for kind, v, e, n in segs:
        assert n >= 1
        if kind == "sparse":
            assert v == tplan.rung(v) and e == tplan.rung(e)
    if alg == "ea":
        assert any(s[0] == "sparse" for s in segs)


def test_run_laddered_with_an_exchanged_companion():
    """run_laddered driven directly (the JAX test's shape), with the JAX
    package's companion carried over: the same state, rounds and record."""
    (jg, je, jp), (tg, te, tp) = _views("scan", 64, seed=2, n_v=64, n_e=1200)
    V = tg.n_vertices
    srcs = np.asarray([1, 2, 3], np.int32)
    jrun = JRunner.for_view(je, windows=_WINDOWS, plan=jp, n_vertices=V, sources=srcs)
    jsegs = []
    jstate, jrnd = jfr.run_laddered(
        jpaths._ea_ladder_spec(JT.SUCCEEDS), je, jrun.windows, jrun.valid, jp, V,
        (jrun.seeded(jem.INT_INF, jrun.windows[:, 0]), jrun.source_frontier()),
        companions=(jfr.companion_for_view(je.src, V),), max_rounds=jrun.max_rounds,
        segments=jsegs)
    runner = FixpointRunner.for_view(te, windows=_WINDOWS, plan=tp, n_vertices=V,
                                     sources=srcs)
    state0 = (runner.seeded(tem.INT_INF, runner.windows[:, 0]), runner.source_frontier())
    for comp in (tfr.companion_for_view(te.src, V),
                 _port_view(jfr.build_frontier_view(je.src, V))):
        segs = []
        state, rnd = tfr.run_laddered(tpaths._ea_ladder_spec(TT.SUCCEEDS), runner, state0,
                                      companions=(comp,), segments=segs)
        assert segs == jsegs and rnd == int(jrnd) == sum(s[3] for s in segs)
        _assert_close(np.asarray(jstate[0]), state[0])


# ---------------------------------------------------------------------------
# 2. where the ladder engages
# ---------------------------------------------------------------------------

def test_ladder_runs_only_in_host_level_over_view_calls(ladder_calls):
    """Under a laddered plan: ``earliest_arrival`` (single window),
    ``earliest_arrival_multi``, every ``*_batched`` entry point and
    ``sweep`` stay dense (the JAX package traces them), with results equal
    to the dense plan's; the ``*_over_view`` calls and the host-level
    ``temporal_betweenness`` ladder."""
    from repro_torch.core import algorithms as talg
    from repro_torch.serve import sweep

    jg, tg, ji, ti = _graph(0)
    lp = tplan.plan_query(tg, ti, windows=_WINDOWS, access="index", ladder=32)
    dp = tplan.plan_query(tg, ti, windows=_WINDOWS, access="index")
    w0 = tuple(int(x) for x in _WINDOWS[0])
    calls = [
        lambda p: talg.earliest_arrival(tg, 1, w0, ti, plan=p),
        lambda p: talg.earliest_arrival_multi(tg, [1, 5], w0, ti, plan=p),
        lambda p: talg.earliest_arrival_batched(tg, 1, _WINDOWS, ti, plan=p),
        lambda p: talg.temporal_bfs_batched(tg, 1, _WINDOWS, ti, plan=p),
        lambda p: talg.temporal_cc_batched(tg, _WINDOWS, ti, plan=p),
        lambda p: talg.temporal_kcore_batched(tg, 2, _WINDOWS, ti, plan=p),
        lambda p: talg.overlaps_reachability_batched(tg, 1, _WINDOWS, ti, plan=p),
        lambda p: talg.temporal_betweenness_batched(tg, 1, _WINDOWS, ti, plan=p,
                                                    n_buckets=16),
        lambda p: sweep(tg, 1, _WINDOWS, ti, plan=p, algorithm="cc"),
        lambda p: sweep(tg, 1, _WINDOWS, ti, plan=p, algorithm="bfs"),
    ]
    for fn in calls:
        got = fn(lp)
        assert ladder_calls == []
        assert _bit_equal(got, fn(dp))
    talg.temporal_betweenness(tg, [1, 5], w0, ti, plan=lp, n_buckets=16)
    assert len(ladder_calls) == 1
    edges = tem.view_for_plan(tg, ti, tem.union_window(_WINDOWS), lp)
    talg.earliest_arrival_over_view(edges, _WINDOWS, plan=lp, n_vertices=tg.n_vertices,
                                    sources=_SRCS)
    assert len(ladder_calls) == 2


def test_serving_ladder_cold_engages_advance_stays_dense(ladder_calls):
    """``sweep_incremental(ladder=N)``: the cold solve runs the ladder
    (results equal to the dense chain's and the JAX package's), the
    advance keeps its dense solves (no laddered call) and logs ``fused``."""
    jg, tg, ji, ti = _graph(4, n_v=64, n_e=512)
    wins = np.asarray([[0, 300], [100, 400], [200, 500]], np.int32)
    r0, _ = tws.sweep_incremental(tg, 3, wins, ti, access="index")
    assert ladder_calls == []
    r1, st = tws.sweep_incremental(tg, 3, wins, ti, access="index", ladder=8)
    assert len(ladder_calls) == 1 and st.plan.ladder == 8
    assert torch.equal(r0, r1)
    j1, _ = jws.sweep_incremental(jg, 3, wins, ji, access="index", ladder=8)
    _assert_close(np.asarray(j1), r1)
    wins2 = wins + 40
    with tws.dispatch_log() as log:
        r2, st2 = tws.sweep_incremental(tg, 3, wins2, ti, access="index", ladder=8,
                                        state=st)
    assert len(ladder_calls) == 1
    assert any(t.startswith("fused") for t in log)
    r2_ref, _ = tws.sweep_incremental(tg, 3, wins2, ti, access="index")
    assert torch.equal(r2, r2_ref)


def test_serve_batch_ladder_rows_equal_dense(ladder_calls):
    """A multi-tenant batch served with ``ladder=8``: the cold start
    ladders each fixpoint group (not PageRank), the advance ladders none
    and logs the same tags as the dense chain; every row equals the
    ``ladder=0`` run's."""
    _, tg, _, ti = _graph(4, n_v=64, n_e=512)

    def batch(shift):
        w = [(600 + shift, 700 + shift), (650 + shift, 750 + shift)]
        return QueryBatch.make(
            [QuerySpec.make("earliest_arrival", x, sources=[3, 7]) for x in w]
            + [QuerySpec.make("bfs", x, sources=[3]) for x in w]
            + [QuerySpec.make("cc", x) for x in w]
            + [QuerySpec.make("kcore", x, k=2) for x in w]
            + [QuerySpec.make("reachability", x, sources=[7]) for x in w]
            + [QuerySpec.make("betweenness", x, sources=[3], n_buckets=16) for x in w]
            + [QuerySpec.make("pagerank", x, n_iters=4) for x in w])

    chains = {}
    for ladder in (0, 8):
        res0, st = tws.serve_batch(tg, batch(0), ti, access="index", ladder=ladder)
        n_cold = len(ladder_calls)
        with tws.dispatch_log() as log:
            res1, st = tws.serve_batch(tg, batch(40), ti, state=st, access="index",
                                       ladder=ladder)
        assert len(ladder_calls) == n_cold
        chains[ladder] = (res0, res1, log, n_cold)
    assert chains[0][3] == 0 and chains[8][3] == 6
    assert chains[8][2] == chains[0][2] == ["fused:index"]
    for a, b in zip(chains[0][:2], chains[8][:2]):
        assert all(_bit_equal(x, y) for x, y in zip(a, b))


def test_tiny_budget_gate_still_raises_naming_its_item():
    """``tiny_budget_gate=True`` is not in the port: it raises, before the
    carried state is touched, naming ROADMAP Queue 2 item 8 (the gate's
    crossover has to be measured on the card)."""
    _, tg, _, ti = _graph(4, n_v=64, n_e=512)
    w0 = np.asarray([[0, 60]], np.int32)
    _, st = tws.sweep_incremental(tg, 3, w0, ti, access="index")
    with pytest.raises(NotImplementedError, match="Queue 2 item 8"):
        tws.sweep_incremental(tg, 3, w0 + 20, ti, access="index", state=st,
                              tiny_budget_gate=True)
    assert not st.consumed


# ---------------------------------------------------------------------------
# 3. the companion view
# ---------------------------------------------------------------------------

def _assert_canonical(fv, from_v, V):
    from_v = np.asarray(from_v)
    perm, offsets, degs = (as_np(a) for a in fv)
    assert perm.dtype == offsets.dtype == degs.dtype == np.int32
    assert (np.sort(perm) == np.arange(from_v.shape[0])).all()
    assert (degs == np.bincount(from_v, minlength=V)).all()
    assert (offsets == np.concatenate([[0], np.cumsum(degs)])).all()
    for v in range(V):
        span = perm[offsets[v]:offsets[v + 1]]
        assert (from_v[span] == v).all() and (span == np.sort(span)).all()


def _assert_views_equal(a, b):
    for x, y in zip(a, b):
        assert (as_np(x) == as_np(y)).all()


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n_v=st.integers(1, 24), n_e=st.integers(1, 120))
def test_build_frontier_view_canonical(seed, n_v, n_e):
    from_v = np.random.default_rng(seed).integers(0, n_v, n_e).astype(np.int32)
    fv = tfr.build_frontier_view(torch.as_tensor(from_v), n_v)
    _assert_canonical(fv, from_v, n_v)
    _assert_views_equal(jfr.build_frontier_view(from_v, n_v), fv)
    assert (as_np(fv.perm) == np.argsort(from_v, kind="stable")).all()


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n_v=st.integers(1, 24), n_e=st.integers(1, 120))
def test_advance_frontier_view_matches_rebuild(seed, n_v, n_e):
    rng = np.random.default_rng(seed)
    from_v = rng.integers(0, n_v, n_e).astype(np.int32)
    fv = tfr.build_frontier_view(torch.as_tensor(from_v), n_v)
    k = int(rng.integers(0, n_e + 1))
    slots = rng.permutation(n_e)[:k].astype(np.int32)      # distinct, any order
    new_vals = rng.integers(0, n_v, k).astype(np.int32)
    new_from = from_v.copy()
    new_from[slots] = new_vals
    adv = tfr.advance_frontier_view(fv, slots, from_v[slots], new_vals, n_v)
    _assert_views_equal(tfr.build_frontier_view(torch.as_tensor(new_from), n_v), adv)
    _assert_views_equal(jfr.advance_frontier_view(jfr.build_frontier_view(from_v, n_v),
                                                  slots, from_v[slots], new_vals, n_v),
                        adv)


def test_companion_tracks_ring_advance_with_wraparound():
    """The serving shape: index-ring advances that wrap the ring, the delta
    triplet from ``ring_companion_delta`` (taken before the in-place
    advance): the advanced companion equals a cold rebuild over the
    advanced view's sources, and the identity-cached companion of the
    advanced (written in place) view is rebuilt, not served stale."""
    _, tg, _, ti = _graph(3)
    V, C = tg.n_vertices, 128
    lo, hi = ttger.window_positions_host(ti, (100, 220))
    assert hi - lo <= C
    view = tem.index_ring_view(tg, ti, lo, hi, capacity=C)
    fv = tfr.build_frontier_view(view.src, V)
    assert tfr.companion_for_view(view.src, V) == tfr.companion_for_view(view.src, V)
    for w_b in [(160, 280), (240, 360), (320, 430)]:        # successive slides
        lo_new, hi_new = ttger.window_positions_host(ti, w_b)
        assert 0 < lo_new - lo <= C                         # forces slot reuse
        slots, old_f, new_f = tem.ring_companion_delta(tg.src, ti.perm_by_start, view,
                                                       lo, lo_new, capacity=C)
        view = tem.advance_index_ring(tg, ti, view, lo, lo_new, hi_new, capacity=C)
        fv = tfr.advance_frontier_view(fv, slots, old_f, new_f, V)
        ref = tfr.build_frontier_view(view.src, V)
        _assert_views_equal(ref, fv)
        _assert_views_equal(ref, tfr.companion_for_view(view.src, V))
        lo, hi = lo_new, hi_new


# ---------------------------------------------------------------------------
# 4. rung selection
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(
    occ_a=st.integers(1, 4096), occ_b=st.integers(1, 4096),
    sd_a=st.integers(1, 1 << 16), sd_b=st.integers(1, 1 << 16),
    prev_v=st.sampled_from([0, 4, 16, 64, 256]),
    prev_e=st.sampled_from([0, 64, 256, 1024, 4096]),
)
def test_choose_rungs_monotone(occ_a, occ_b, sd_a, sd_b, prev_v, prev_e):
    kw = dict(cap=4096, n_slots=1 << 16, n_vertices=4096)
    lo_occ, hi_occ = sorted((occ_a, occ_b))
    lo_sd, hi_sd = sorted((sd_a, sd_b))
    v_lo, e_lo = tfr.choose_rungs(lo_occ, lo_sd, prev_v, prev_e, **kw)
    v_hi, e_hi = tfr.choose_rungs(hi_occ, hi_sd, prev_v, prev_e, **kw)
    assert v_lo <= v_hi and e_lo <= e_hi
    assert (v_lo, e_lo) == jfr.choose_rungs(lo_occ, lo_sd, prev_v, prev_e, **kw)
    assert (v_hi, e_hi) == jfr.choose_rungs(hi_occ, hi_sd, prev_v, prev_e, **kw)
    # rungs are pow2-or-held, bounded, and cover the measured frontier
    for v, e, occ in ((v_lo, e_lo, lo_occ), (v_hi, e_hi, hi_occ)):
        assert v == tplan.rung(v) and e == tplan.rung(e)
        assert e >= min(tfr.ERUNG_FLOOR, kw["n_slots"])
        assert v >= min(occ, kw["cap"]) or v == tplan.rung(kw["cap"])


# ---------------------------------------------------------------------------
# 5. frontier_trace
# ---------------------------------------------------------------------------

def _ea_trace_oracle(src, dst, ts, te, V, source, window, max_rounds):
    """Host reference of the label-correcting EA's per-round touched
    counts (``SUCCEEDS``): vertices receiving >= 1 valid contribution."""
    ta, tb = window
    wvalid = (ts >= ta) & (te <= tb)
    arrival = np.full(V, np.iinfo(np.int32).max, np.int64)
    arrival[source] = ta
    frontier = np.zeros(V, bool)
    frontier[source] = True
    trace = []
    while frontier.any() and len(trace) < max_rounds:
        ok = wvalid & frontier[src] & (arrival[src] <= ts)
        touched = np.zeros(V, bool)
        touched[dst[ok]] = True
        trace.append(int(touched.sum()))
        cand = np.full(V, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(cand, dst[ok], te[ok])
        new_arrival = np.minimum(arrival, cand)
        frontier = new_arrival < arrival
        arrival = new_arrival
    return trace


@pytest.mark.parametrize("max_rounds", [24, 0])
def test_frontier_trace_matches_host_oracle_and_jax(max_rounds):
    jg, tg, ji, ti = _graph(1)
    window, source = (50, 800), 3
    arr, metrics = tpaths.earliest_arrival(tg, source, window, ti, with_metrics=True,
                                           frontier_trace=True, max_rounds=max_rounds)
    cap = max_rounds or tg.n_vertices + 1
    ref = _ea_trace_oracle(*(as_np(a).astype(np.int64) for a in
                             (tg.src, tg.dst, tg.t_start, tg.t_end)),
                           tg.n_vertices, source, window, cap)
    got = as_np(metrics.frontier_trace)
    assert got.shape == (cap,) and got.dtype == np.int32
    assert metrics.rounds == len(ref)
    assert (got[:len(ref)] == np.asarray(ref)).all() and (got[len(ref):] == -1).all()
    assert metrics.touched_total == sum(ref)
    j_arr, j_metrics = jpaths.earliest_arrival(jg, source, window, ji, with_metrics=True,
                                               frontier_trace=True, max_rounds=max_rounds)
    assert (np.asarray(j_metrics.frontier_trace) == got).all()
    _assert_close(np.asarray(j_arr), arr)
    _, plain = tpaths.earliest_arrival(tg, source, window, ti, with_metrics=True)
    assert plain.frontier_trace is None and plain.rounds == metrics.rounds
