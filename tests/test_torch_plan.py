"""The port's planner (cost model, budgets, plans, tile layout) against the
JAX package on the same graphs and windows; decisions must be identical."""
import numpy as np
import pytest

import repro.core.coldstore as jcold
import repro.core.histogram as jhist
import repro.core.selective as jsel
import repro.core.tger as jtger
import repro.data.generators as jgen
import repro.engine.plan as jplan
import repro.kernels.layout as jlayout
import repro_torch.core.coldstore as tcold
import repro_torch.core.histogram as thist
import repro_torch.core.selective as tsel
import repro_torch.core.tger as ttger
import repro_torch.data.generators as tgen
import repro_torch.engine.plan as tplan
import repro_torch.engine.queries as tqueries
import repro_torch.kernels.layout as tlayout
from test_torch_common import CPU, as_np, assert_astuple_in_reference_order, assert_fields_equal


def _pair(kind, seed):
    if kind == "power_law":
        kw = dict(n_vertices=250, n_edges=6000, seed=seed)
    else:
        kw = dict(n_vertices=250, n_edges=3000, seed=seed, headway=300)
    fn = f"{kind}_temporal_graph"
    jg, tg = getattr(jgen, fn)(**kw), getattr(tgen, fn)(**kw, device=CPU)
    return jg, tg, jtger.build_tger(jg, degree_cutoff=40), ttger.build_tger(
        tg, degree_cutoff=40)


def _windows(jg):
    """About twenty windows: quantile starts to the end, the narrow
    span/50 window, early and empty ones."""
    ts = np.asarray(jg.t_start)
    t_lo, t_hi = int(ts.min()), int(np.asarray(jg.t_end).max())
    span = t_hi - t_lo
    wins = [(int(np.quantile(ts, q)), t_hi)
            for q in (0.0, 0.2, 0.4, 0.6, 0.8, 0.9, 0.95, 0.98, 0.99, 0.995, 0.999)]
    wins += [(t_hi - span // 50, t_hi), (t_hi - span // 10, t_hi - span // 20),
             (t_lo, t_lo + span // 50), (t_lo, t_lo + span // 3),
             (t_lo + span // 2, t_lo + span // 2 + span // 50),
             (t_hi + 5, t_hi + 9), (t_lo - 100, t_lo - 1), (t_lo, t_hi)]
    return wins


_PLAN_FIELDS = ["method", "backend", "budget", "per_vertex_budget", "tile_v",
                "block_e", "n_tiles", "n_edges", "cache_key", "n_windows",
                "ring_capacity", "tier", "layout_perm", "layout_block_tile"]


@pytest.mark.parametrize("kind", ["power_law", "transit"])
def test_decide_access_identical(kind):
    jg, tg, ji, ti = _pair(kind, 3)
    model = jsel.CostModel()
    for w in _windows(jg):
        for force in (None, "index", "scan"):
            a = jsel.decide_access(ji, jg.n_edges, w, model, force=force)
            b = tsel.decide_access(ti, tg.n_edges, w, tsel.CostModel(), force=force)
            assert a.__dict__ == b.__dict__, (w, force)
    for k in (0.0, 10.0, 63.2, 1000.0, 5e6):
        for e in (1, 100, 6000, 10**7):
            assert jsel.budget_for(k, e, model) == tsel.budget_for(k, e, tsel.CostModel())


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access", ["auto", "scan", "index", "hybrid"])
@pytest.mark.parametrize("backend", ["xla_segment", "pallas_tiled"])
def test_plan_query_identical(kind, access, backend):
    jg, tg, ji, ti = _pair(kind, 5)
    for w in _windows(jg):
        a = jplan.plan_query(jg, ji, w, access=access, backend=backend)
        b = tplan.plan_query(tg, ti, w, access=access, backend=backend)
        assert_fields_equal(a, b, _PLAN_FIELDS)
    # batched plans over sliding windows
    wins = _windows(jg)[5:11]
    a = jplan.plan_query(jg, ji, windows=wins, access=access, backend=backend)
    b = tplan.plan_query(tg, ti, windows=np.asarray(wins), access=access,
                         backend=backend)
    assert_fields_equal(a, b, _PLAN_FIELDS)


def test_plan_query_without_index_and_errors():
    jg, tg, ji, ti = _pair("power_law", 7)
    w = _windows(jg)[3]
    assert_fields_equal(jplan.plan_query(jg, None, w),
                        tplan.plan_query(tg, None, w), _PLAN_FIELDS)
    for kw in (dict(access="index"), dict(access="nope"), dict(backend="nope")):
        with pytest.raises(ValueError):
            tplan.plan_query(tg, None if kw.get("access") == "index" else ti, w, **kw)
    with pytest.raises(ValueError):
        tplan.plan_query(tg, ti)
    with pytest.raises(ValueError):
        tplan.plan_query(tg, ti, w, windows=[w])
    with pytest.raises(ValueError):
        tplan.make_plan("scan", "pallas_tiled")


@pytest.mark.parametrize("kw,item", [
    (dict(exchange_budget=8), "item 14"),
])
def test_out_of_slice_options_raise(kw, item):
    """The options ROADMAP Queue 1 ``item`` ported no longer raise: the
    distributed exchange budget is a plan field on the cache key (``x8``),
    as in the JAX package, for every access method."""
    jg, tg, ji, ti = _pair("power_law", 7)
    for access in ("auto", "scan", "index", "hybrid"):
        jp = jplan.plan_query(jg, ji, (0, 10), access=access, **kw)
        tp = tplan.plan_query(tg, ti, (0, 10), access=access, **kw)
        assert tp.cache_key == jp.cache_key and "/x8/" in tp.cache_key
        assert tp.exchange_budget == jp.exchange_budget == 8
        assert tp.edge_axis is None
    mk = tplan.make_plan("index", budget=64, exchange_budget=16)
    assert mk.cache_key == jplan.make_plan("index", budget=64,
                                           exchange_budget=16).cache_key


@pytest.mark.parametrize("tier", ["hot", "cold", "split"])
@pytest.mark.parametrize("access", ["auto", "index"])
@pytest.mark.parametrize("backend", ["xla_segment", "pallas_tiled"])
def test_tier_plan_matches_jax(tier, access, backend):
    """A cold store half-way through the history classifies a window
    above, below and across its watermark as in the JAX package: the
    same tier, an index plan with the span's capacity rung below the
    horizon, and the same cache key (``/Tcold``, ``/Tsplit``), single-
    window and batch plans alike; ``tier=`` overrides the store."""
    jg, tg, ji, ti = _pair("power_law", 7)
    jcs = jcold.ColdStore(jg, ji, chunk_slots=256)
    tcs = tcold.ColdStore(tg, ti, chunk_slots=256)
    wm = jg.n_edges // 2
    jcs.note_eviction(wm)
    tcs.note_eviction(wm)
    t_wm = int(np.asarray(ji.start_sorted)[wm])
    ts = np.asarray(jg.t_start)
    t_lo, t_hi = int(ts.min()), int(np.asarray(jg.t_end).max())
    win = {"hot": (t_wm + 1, t_hi), "cold": (t_lo, t_wm - (t_hi - t_lo) // 50),
           "split": (t_wm - (t_hi - t_lo) // 20, t_wm + (t_hi - t_lo) // 20)}[tier]
    kw = dict(access=access, backend=backend)
    a = jplan.plan_query(jg, ji, win, coldstore=jcs, **kw)
    b = tplan.plan_query(tg, ti, win, coldstore=tcs, **kw)
    assert a.tier == b.tier == tier
    assert_fields_equal(a, b, _PLAN_FIELDS)
    if tier != "hot":
        assert b.method == "index" and b.cache_key.endswith(f"/T{tier}")
    # the override, without a store
    a = jplan.plan_query(jg, ji, windows=[win, (win[0], win[0] + 5)], tier=tier, **kw)
    b = tplan.plan_query(tg, ti, windows=[win, (win[0], win[0] + 5)], tier=tier, **kw)
    assert_fields_equal(a, b, _PLAN_FIELDS)
    import repro.engine.queries as jqueries
    jb = jqueries.QueryBatch.make([jqueries.QuerySpec.make("cc", win)])
    tb = tqueries.QueryBatch.make([tqueries.QuerySpec.make("cc", win)])
    for bucketed in (False, True):
        assert (tplan.plan_batch(tg, ti, tb, coldstore=tcs, bucketed=bucketed, **kw).cache_key
                == jplan.plan_batch(jg, ji, jb, coldstore=jcs, bucketed=bucketed,
                                    **kw).cache_key)


def test_tier_plan_errors_as_in_jax():
    """Below-horizon tiers need a TGER and the index method; an unknown
    tier raises: both packages raise ValueError alike."""
    jg, tg, ji, ti = _pair("power_law", 7)
    for fn, g, i in ((jplan.plan_query, jg, ji), (tplan.plan_query, tg, ti)):
        with pytest.raises(ValueError, match="TGER"):
            fn(g, None, (0, 10), tier="cold")
        for access in ("scan", "hybrid"):
            with pytest.raises(ValueError, match="index"):
                fn(g, i, (0, 10), tier="split", access=access)
        with pytest.raises(ValueError, match="tier"):
            fn(g, i, (0, 10), tier="lukewarm")
    with pytest.raises(ValueError, match="tier"):
        tplan.make_plan("index", tier="lukewarm")


def test_ladder_rides_the_cache_key_as_in_jax():
    """``ladder=4`` is planned (the frontier ladder is in the port): the
    plan carries it and its cache key equals the JAX plan's, ``/L4``
    included, for single-window, batched and batch plans; a negative
    ladder raises as in the JAX package."""
    jg, tg, ji, ti = _pair("power_law", 7)
    wins = _windows(jg)[:3]
    for access in ("scan", "index", "hybrid"):
        jp = jplan.plan_query(jg, ji, wins[1], access=access, ladder=4)
        tp = tplan.plan_query(tg, ti, wins[1], access=access, ladder=4)
        assert tp.ladder == 4 and tp.cache_key == jp.cache_key
        assert tp.cache_key.endswith("/L4")
        jp = jplan.plan_query(jg, ji, windows=wins, access=access, ladder=4)
        tp = tplan.plan_query(tg, ti, windows=wins, access=access, ladder=4)
        assert tp.cache_key == jp.cache_key
    import repro.engine.queries as jqueries
    jb = jqueries.QueryBatch.make([jqueries.QuerySpec.make("cc", wins[0])])
    tb = tqueries.QueryBatch.make([tqueries.QuerySpec.make("cc", wins[0])])
    assert (tplan.plan_batch(tg, ti, tb, ladder=4).cache_key
            == jplan.plan_batch(jg, ji, jb, ladder=4).cache_key)
    for fn, g, i in ((jplan.plan_query, jg, ji), (tplan.plan_query, tg, ti)):
        with pytest.raises(ValueError, match="ladder"):
            fn(g, i, (0, 10), ladder=-1)


def test_plan_batch_not_ported():
    """plan_batch is ported with every form (the name predates its sharded
    form): the bucketed and the sharded keys equal the JAX ones."""
    jg, tg, ji, ti = _pair("power_law", 7)
    batch = tqueries.QueryBatch.make([tqueries.QuerySpec.make("cc", (0, 10))])
    import repro.engine.queries as jqueries
    jbatch = jqueries.QueryBatch.make([jqueries.QuerySpec.make("cc", (0, 10))])
    # the sharded form: the mesh shape rides the signature, (1, D) is the
    # 1-D form, and the keys equal the JAX package's
    for shards, suffix in ((2, "@q2"), ((1, 4), "@q4"), ((2, 2), "@e2q2"),
                           ((4, 1), "@e4q1")):
        key = tplan.plan_batch(tg, ti, batch, shards=shards).cache_key
        assert key == jplan.plan_batch(jg, ji, jbatch, shards=shards).cache_key
        assert key.endswith(suffix)
    jb = jqueries.QueryBatch.make([jqueries.QuerySpec.make("cc", (0, 10))] * 3)
    tb = tqueries.QueryBatch.make([tqueries.QuerySpec.make("cc", (0, 10))] * 3)
    key = tplan.plan_batch(tg, ti, tb, bucketed=True).cache_key
    assert key == jplan.plan_batch(jg, ji, jb, bucketed=True).cache_key
    assert "ccx4b" in key


@pytest.mark.parametrize("member", ["n_buckets", "scan", "index", "hybrid"])
def test_public_members_identical(member):
    """``Histogram2D.n_buckets`` of built and stacked histograms, and
    ``AccessPlan.view_budget`` of each method's plans, equal the JAX
    package's."""
    jg, tg, ji, ti = _pair("power_law", 11)
    if member == "n_buckets":
        ts, te = np.asarray(jg.t_start), np.asarray(jg.t_end)
        for nb in (1, 7, 100):
            j, t = jhist.build_histogram(ts, te, nb), thist.build_histogram(ts, te, nb)
            assert t.n_buckets == j.n_buckets == nb
            j2 = jhist.stack_histograms([j, j])
            assert thist.stack_histograms([t, t]).n_buckets == j2.n_buckets == nb
        return
    budgets = set()
    for w in _windows(jg):
        jp = jplan.plan_query(jg, ji, w, access=member)
        tp = tplan.plan_query(tg, ti, w, access=member)
        assert tp.method == jp.method
        assert tp.view_budget == jp.view_budget
        if tp.method == member:
            budgets.add(tp.view_budget)
    # a wide window's index plan falls back to a scan, whose budget is 0
    assert len(budgets) > (member != "scan")


@pytest.mark.parametrize("access", ["scan", "index", "hybrid"])
@pytest.mark.parametrize("backend", ["xla_segment", "pallas_tiled"])
def test_plan_astuple_in_reference_order(access, backend):
    """Positional views of a plan (``astuple``) line up with the JAX
    package's fields, a batch plan's and a direct ``make_plan``'s too."""
    jg, tg, ji, ti = _pair("power_law", 5)
    w = _windows(jg)[11]
    assert_astuple_in_reference_order(
        jplan.plan_query(jg, ji, w, access=access, backend=backend, exchange_budget=64),
        tplan.plan_query(tg, ti, w, access=access, backend=backend, exchange_budget=64))
    import repro.engine.queries as jqueries

    jb = jqueries.QueryBatch.make([jqueries.QuerySpec.make("cc", w)] * 2)
    tb = tqueries.QueryBatch.make([tqueries.QuerySpec.make("cc", w)] * 2)
    assert_astuple_in_reference_order(
        jplan.plan_batch(jg, ji, jb, access=access, backend=backend),
        tplan.plan_batch(tg, ti, tb, access=access, backend=backend))
    kw = dict(budget=256, per_vertex_budget=32, exchange_budget=16, n_windows=3,
              ring_capacity=512, batch_sig="cc2", tier="split", ladder=8)
    if backend == "xla_segment":
        assert_astuple_in_reference_order(jplan.make_plan(access, backend, **kw),
                                          tplan.make_plan(access, backend, **kw))


@pytest.mark.parametrize("kind", ["power_law", "transit"])
def test_budgets_identical(kind):
    jg, tg, ji, ti = _pair(kind, 9)
    for w in _windows(jg):
        for floor in (1, 16):
            assert (jplan.per_vertex_window_budget(jg, ji, w, floor=floor)
                    == tplan.per_vertex_window_budget(tg, ti, w, floor=floor))
        assert (jplan.heavy_window_budget(jg, ji, w)
                == tplan.heavy_window_budget(tg, ti, w))
    for n in (0, 1, 2, 3, 64, 65, 1000):
        assert jplan.rung(n) == tplan.rung(n)


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e", [
    (100, 700, 64, 128),
    (700, 6000, 256, 512),
    (513, 2000, 128, 256),
    (64, 64, 64, 128),
    (50, 0, 64, 128),
])
def test_build_tile_layout_identical(n_v, n_e, tile_v, block_e):
    dst = np.random.default_rng(n_e).integers(0, n_v, n_e)
    a = jlayout.build_tile_layout(dst, n_v, tile_v, block_e)
    b = tlayout.build_tile_layout(dst, n_v, tile_v, block_e)
    assert_fields_equal(a, b)
    assert b.perm.dtype == np.int32 and b.block_tile.dtype == np.int32


def test_tiled_plan_layout_follows_graph():
    jg, tg, ji, ti = _pair("power_law", 3)
    w = _windows(jg)[0]
    b = tplan.plan_query(tg, ti, w, access="scan", backend="pallas_tiled")
    again = tplan.plan_query(tg, ti, w, access="scan", backend="pallas_tiled")
    assert b.layout_perm.device.type == "cpu"
    assert b.layout_perm is again.layout_perm  # built once per graph
    lay = tlayout.build_tile_layout(as_np(tg.dst), tg.n_vertices, 512, 1024)
    assert (as_np(b.layout_perm) == lay.perm).all()
