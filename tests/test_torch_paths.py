"""The temporal-path algorithms in the port against the JAX package and the
numpy oracles: earliest arrival end to end (every plan cell, strict /
visit-once / metrics / multi-source variants, the batched solver and the
window sweep), then latest departure, fastest and shortest duration in
every plan cell.  Exact equality (shortest duration's float32 staircase is
min-only arithmetic, so bit for bit too)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.core.algorithms as jalg
import repro.core.predicates as jpred
import repro.engine.plan as jplan
import repro.serve.window_sweep as jsweep
import repro_torch.core.algorithms as talg
import repro_torch.core.predicates as tpred
import repro_torch.engine.plan as tplan
import repro_torch.serve.window_sweep as tsweep
import repro.core.reference as R
import repro.data.generators as jgen
import repro.engine as jengine
import repro_torch.data.generators as tgen
import repro_torch.engine as tengine
from repro.core.reference import earliest_arrival_ref
from repro.core.tger import build_tger as jbuild
from repro_torch.core.edgemap import view_for_plan
from repro_torch.core.tger import build_tger as tbuild
from test_torch_common import CELLS, as_np, assert_same, both_graphs, plans, query_setup

INF = 2**31 - 1

_setup = query_setup


def _eq(a, b):
    return (np.asarray(a) == as_np(b)).all()


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access", ["scan", "index", "hybrid"])
@pytest.mark.parametrize("backend", ["xla_segment", "pallas_tiled"])
def test_earliest_arrival_plan_cells(kind, access, backend):
    jg, tg, ji, ti, wins, sources = _setup(kind)
    for w in wins:
        jp = jplan.plan_query(jg, ji, w, access=access, backend=backend)
        tp = tplan.plan_query(tg, ti, w, access=access, backend=backend)
        assert jp.cache_key == tp.cache_key
        for s in sources:
            want = np.asarray(jalg.earliest_arrival(jg, s, w, ji, plan=jp))
            got = talg.earliest_arrival(tg, s, w, ti, plan=tp)
            assert got.dtype == torch.int32 and got.shape == (tg.n_vertices,)
            assert _eq(want, got), (w, s)
            assert (want == earliest_arrival_ref(jg, s, w)).all()


@pytest.mark.parametrize("backend", ["xla_segment", "pallas_tiled"])
def test_earliest_arrival_edgeless_graph(backend):
    """No edges: the tiled plan's layout is one all-padding block, which the
    combine runs through K1's path.  The JAX package's tiled combine cannot
    gather from the empty edge set, so both plans are held to its segment
    result."""
    jg, tg = both_graphs(np.zeros(0, np.int64), np.zeros(0, np.int64),
                         np.zeros(0, np.int64), n_vertices=5)
    jp = jplan.plan_query(jg, None, (0, 10), backend=backend)
    tp = tplan.plan_query(tg, None, (0, 10), backend=backend)
    assert jp.cache_key == tp.cache_key
    want = np.asarray(jalg.earliest_arrival(jg, 2, (0, 10), None))
    got = talg.earliest_arrival(tg, 2, (0, 10), None, plan=tp)
    assert _eq(want, got)
    assert as_np(got).tolist() == [INF, INF, 0, INF, INF]


@pytest.mark.parametrize("kind", ["power_law", "transit"])
def test_earliest_arrival_variants(kind):
    jg, tg, ji, ti, wins, sources = _setup(kind)
    w, s = wins[0], sources[0]
    jp = jplan.plan_query(jg, ji, w, access="scan", backend="pallas_tiled")
    tp = tplan.plan_query(tg, ti, w, access="scan", backend="pallas_tiled")
    strict = talg.earliest_arrival(tg, s, w, ti, plan=tp,
                                   pred=tpred.OrderingPredicateType.STRICTLY_SUCCEEDS)
    assert _eq(jalg.earliest_arrival(
        jg, s, w, ji, plan=jp, pred=jpred.OrderingPredicateType.STRICTLY_SUCCEEDS), strict)
    assert _eq(earliest_arrival_ref(jg, s, w, pred="strictly_succeeds"), strict)
    assert _eq(jalg.earliest_arrival(jg, s, w, ji, plan=jp, visit_once=True),
               talg.earliest_arrival(tg, s, w, ti, plan=tp, visit_once=True))
    assert _eq(jalg.earliest_arrival(jg, s, w, ji, plan=jp, max_rounds=2),
               talg.earliest_arrival(tg, s, w, ti, plan=tp, max_rounds=2))
    ja, jm = jalg.earliest_arrival(jg, s, w, ji, plan=jp, with_metrics=True)
    ta, tm = talg.earliest_arrival(tg, s, w, ti, plan=tp, with_metrics=True)
    assert _eq(ja, ta)
    assert (int(jm.rounds), int(jm.touched_total)) == (tm.rounds, tm.touched_total)
    # multi-seed single query, and multi-source rows
    assert _eq(jalg.earliest_arrival(jg, jnp.asarray(sources), w, ji, plan=jp),
               talg.earliest_arrival(tg, sources, w, ti, plan=tp))
    for plan_pair in ((jp, tp), (None, None)):
        want = jalg.earliest_arrival_multi(jg, sources, w, ji, plan=plan_pair[0])
        got = talg.earliest_arrival_multi(tg, sources, w, ti, plan=plan_pair[1])
        assert got.shape == (len(sources), tg.n_vertices) and _eq(want, got)


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access,backend", [("index", "xla_segment"),
                                            ("scan", "pallas_tiled")])
def test_over_view_per_row_sources(kind, access, backend):
    jg, tg, ji, ti, wins, sources = _setup(kind)
    rows_w = np.asarray([wins[0], wins[1], wins[0], wins[2]], np.int32)
    rows_s = np.asarray([sources[0], sources[1], sources[1], sources[0]], np.int32)
    jp = jplan.plan_query(jg, ji, windows=rows_w, access=access, backend=backend)
    tp = tplan.plan_query(tg, ti, windows=rows_w, access=access, backend=backend)
    union = (int(rows_w[:, 0].min()), int(rows_w[:, 1].max()))
    from repro.core.edgemap import view_for_plan as jview

    want, jr = jalg.earliest_arrival_over_view(
        jview(jg, ji, union, jp), jnp.asarray(rows_w), plan=jp,
        n_vertices=jg.n_vertices, sources=jnp.asarray(rows_s), with_rounds=True)
    got, tr = talg.earliest_arrival_over_view(
        view_for_plan(tg, ti, union, tp), rows_w, plan=tp, n_vertices=tg.n_vertices,
        sources=rows_s, with_rounds=True)
    assert _eq(want, got) and int(jr) == tr
    init = np.array(want)  # a converged warm start stays put
    assert _eq(want, talg.earliest_arrival_over_view(
        view_for_plan(tg, ti, union, tp), rows_w, plan=tp,
        n_vertices=tg.n_vertices, init=torch.as_tensor(init)))


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access", ["auto", "index", "hybrid"])
@pytest.mark.parametrize("backend", ["xla_segment", "pallas_tiled"])
def test_sweep_matches_jax_and_looped(kind, access, backend):
    jg, tg, ji, ti, wins, sources = _setup(kind)
    t_hi = int(np.asarray(jg.t_end).max())
    span = t_hi - int(np.asarray(jg.t_start).min())
    windows = tsweep.sliding_windows(t_hi, width=span // 4, stride=span // 12, count=6)
    assert (windows == jsweep.sliding_windows(t_hi, span // 4, span // 12, 6)).all()
    s = sources[0]
    want = jsweep.sweep(jg, s, windows, ji, access=access, backend=backend)
    got = tsweep.sweep(tg, s, windows, ti, access=access, backend=backend)
    looped = tsweep.sweep_looped(tg, s, windows, ti, access=access, backend=backend)
    assert got.shape == (6, tg.n_vertices)
    assert _eq(want, got) and torch.equal(got, looped)
    tp = tplan.plan_query(tg, ti, windows=windows, access=access, backend=backend)
    assert torch.equal(got, talg.earliest_arrival_batched(tg, s, windows, ti, plan=tp))


def test_sweep_rejects_other_algorithms():
    """An algorithm outside the JAX package's ALGORITHMS is refused with the
    list of the ones the sweep serves."""
    _, tg, _, ti, wins, _ = _setup("transit")
    assert tsweep.ALGORITHMS == jsweep.ALGORITHMS
    for fn in (tsweep.sweep, tsweep.sweep_looped):
        with pytest.raises(ValueError, match="earliest_arrival"):
            fn(tg, 0, [wins[0]], ti, algorithm="latest_departure")
    with pytest.raises(ValueError):
        talg.earliest_arrival_batched(tg, [0, 1], [wins[0]], ti)
    with pytest.raises(ValueError):
        tsweep.sliding_windows(10, 0, 1, 1)


# ---------------------------------------------------------------------------
# latest departure, fastest, shortest duration
# ---------------------------------------------------------------------------

SUCCEEDS = ("SUCCEEDS", "STRICTLY_SUCCEEDS")


def _preds(name):
    return (getattr(jpred.OrderingPredicateType, name),
            getattr(tpred.OrderingPredicateType, name))


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access,backend", CELLS)
def test_rest_of_paths_plan_cells(kind, access, backend):
    """latest_departure, fastest and shortest_duration equal the JAX
    package's in every plan cell, on every window from both sources."""
    jg, tg, ji, ti, wins, sources = _setup(kind)
    for w in wins:
        jp, tp = plans(jg, tg, ji, ti, access, backend, window=w)
        for s in sources:
            for name in ("latest_departure", "fastest", "shortest_duration"):
                want = getattr(jalg, name)(jg, s, w, ji, plan=jp)
                got = getattr(talg, name)(tg, s, w, ti, plan=tp)
                assert_same(want, got)


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("pred", SUCCEEDS)
def test_rest_of_paths_predicates(kind, pred):
    """Both succeeds predicates on the tiled and the index plan; fastest
    with a departure ladder longer than the source's window range."""
    jg, tg, ji, ti, wins, sources = _setup(kind)
    jpr, tpr = _preds(pred)
    w, s = wins[0], sources[0]
    for access, backend in (("scan", "pallas_tiled"), ("index", "xla_segment")):
        jp, tp = plans(jg, tg, ji, ti, access, backend, window=w)
        for name, kw in (("latest_departure", {}), ("fastest", {"n_departures": 64}),
                         ("shortest_duration", {})):
            assert_same(getattr(jalg, name)(jg, s, w, ji, plan=jp, pred=jpr, **kw),
                        getattr(talg, name)(tg, s, w, ti, plan=tp, pred=tpr, **kw))


def test_latest_departure_rejects_overlaps():
    _, tg, _, ti, wins, sources = _setup("transit")
    with pytest.raises(ValueError, match="succeeds predicates"):
        talg.latest_departure(tg, sources[0], wins[0], ti,
                              pred=tpred.OrderingPredicateType.OVERLAPS)


@pytest.mark.parametrize("n_buckets", [7, 64, 100])
@pytest.mark.parametrize("use_weights", [False, True])
def test_shortest_duration_buckets_bit_identical(n_buckets, use_weights):
    """The staircase's bucket bounds round as the compiled JAX program's
    (a multiplication by 1/P), so P = 7 and 100 agree bit for bit too."""
    jg, tg, ji, ti, wins, sources = _setup("power_law")
    for w in wins:
        want = jalg.shortest_duration(jg, sources[0], w, ji, n_buckets=n_buckets,
                                      use_weights=use_weights)
        got = talg.shortest_duration(tg, sources[0], w, ti, n_buckets=n_buckets,
                                     use_weights=use_weights)
        assert_same(want, got)


_GOLDEN = {}


def _golden(seed):
    """test_golden_reference.py's case: a synthetic graph, its TGER and the
    three covering plans, in both packages."""
    if seed not in _GOLDEN:
        jg = jgen.synthetic_temporal_graph(36, 240, seed=seed)
        tg = tgen.synthetic_temporal_graph(36, 240, seed=seed, device="cpu")
        ji = jbuild(jg, degree_cutoff=8, n_time_buckets=8)
        ti = tbuild(tg, degree_cutoff=8, n_time_buckets=8)
        ts = np.asarray(jg.t_start)
        win = (int(np.quantile(ts, 0.3)), int(np.asarray(jg.t_end).max()))
        in_win = int(((ts >= win[0]) & (ts <= win[1])).sum())
        budget = max(64, 1 << in_win.bit_length())
        kb = jengine.per_vertex_window_budget(jg, ji, win)
        assert kb == tplan.per_vertex_window_budget(tg, ti, win)
        cells = {"scan": dict(), "index": dict(budget=budget),
                 "hybrid": dict(per_vertex_budget=kb)}
        src = int(np.asarray(jg.src)[seed % jg.n_edges])
        _GOLDEN[seed] = (jg, tg, ti, win, cells, src)
    return _GOLDEN[seed]


@pytest.mark.parametrize("seed", [5, 19])
def test_rest_of_paths_against_oracles(seed):
    """The oracles of repro/core/reference.py, as test_golden_reference.py
    holds the JAX package to them, through scan, index and hybrid plans."""
    jg, tg, ti, win, cells, src = _golden(seed)
    ld = R.latest_departure_ref(jg, src, win)
    fa = R.fastest_ref(jg, src, win)
    sd = R.shortest_duration_ref(jg, src, win)
    finite = np.isfinite(sd)
    for method, kw in cells.items():
        plan = tengine.make_plan(method, **kw)
        assert (as_np(talg.latest_departure(tg, src, win, ti, plan=plan)) == ld).all()
        assert (as_np(talg.fastest(tg, src, win, ti, plan=plan, n_departures=256))
                == fa).all(), method
        got = as_np(talg.shortest_duration(tg, src, win, ti, plan=plan, n_buckets=256))
        assert (np.isfinite(got) == finite).all() and (got[finite] == sd[finite]).all()
