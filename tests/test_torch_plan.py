"""The port's planner (cost model, budgets, plans, tile layout) against the
JAX package on the same graphs and windows; decisions must be identical."""
import numpy as np
import pytest

import repro.core.selective as jsel
import repro.core.tger as jtger
import repro.data.generators as jgen
import repro.engine.plan as jplan
import repro.kernels.layout as jlayout
import repro_torch.core.selective as tsel
import repro_torch.core.tger as ttger
import repro_torch.data.generators as tgen
import repro_torch.engine.plan as tplan
import repro_torch.engine.queries as tqueries
import repro_torch.kernels.layout as tlayout
from test_torch_common import CPU, as_np, assert_fields_equal


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
                "ring_capacity", "layout_perm", "layout_block_tile"]


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
    (dict(coldstore=object()), "item 12"),
    (dict(tier="cold"), "item 12"),
    (dict(exchange_budget=8), "item 14"),
])
def test_out_of_slice_options_raise(kw, item):
    _, tg, _, ti = _pair("power_law", 7)
    with pytest.raises(NotImplementedError, match=item):
        tplan.plan_query(tg, ti, (0, 10), **kw)


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
    """plan_batch is ported; its sharded and bucketed forms are not yet."""
    _, tg, _, ti = _pair("power_law", 7)
    batch = tqueries.QueryBatch.make([tqueries.QuerySpec.make("cc", (0, 10))])
    with pytest.raises(NotImplementedError, match="item 14"):
        tplan.plan_batch(tg, ti, batch, shards=2)
    with pytest.raises(NotImplementedError, match="item 13"):
        tplan.plan_batch(tg, ti, batch, bucketed=True)


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
