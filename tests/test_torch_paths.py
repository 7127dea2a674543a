"""Earliest arrival end to end in the port against the JAX package and the
numpy oracle: every plan cell, strict/visit-once/metrics/multi-source
variants, the batched solver and the window sweep.  Exact equality."""
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
from repro.core.reference import earliest_arrival_ref
from repro_torch.core.edgemap import view_for_plan
from test_torch_common import as_np, both_graphs, query_setup

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
