"""The port's TemporalEdgeMap primitives (``repro_torch.core.edgemap``)
against the JAX package's on the same graphs: ``test_edgemap.py``,
``test_hybrid.py``, ``test_tger.py::test_vertex_prefix_strict_vs_nonstrict``,
``test_engine.py::test_pallas_backend_inside_edgemap_min`` (the port's K1
plain version against the Pallas kernel in interpret mode) and
``test_fixpoint.py::test_compute_touched_plumbing``, each held to the JAX
result bit for bit; every primitive, single-window and batched, against
the JAX package's in every plan cell, combine and direction; and an EA
loop written with the primitives alone."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.edgemap as jem
import repro.core.temporal_graph as jtg
import repro.core.tger as jtger
import repro.data.generators as jgen
import repro.engine as jengine
import repro.core.algorithms as jalg
import repro_torch.core as tcore
import repro_torch.core.edgemap as tem
import repro_torch.core.temporal_graph as ttg
import repro_torch.core.tger as ttger
import repro_torch.data.generators as tgen
import repro_torch.engine as tengine
import repro_torch.core.algorithms as talg
from repro.core.predicates import OrderingPredicateType as JT, edge_follows as j_follows
from repro.core.selective import CostModel as JCost
from repro_torch.core.predicates import OrderingPredicateType as TT, edge_follows as t_follows
from repro_torch.core.selective import CostModel as TCost
from test_torch_common import CELLS, CPU, as_np, plans


def _graph_pair(src, dst, ts, te=None, n_vertices=None, seed=0):
    """Both packages' graph from one edge list (a missing ``te`` sampled
    from the same seeded generator)."""
    jg = jtg.from_edges(src, dst, ts, te, n_vertices=n_vertices,
                        rng=np.random.default_rng(seed))
    tg = ttg.from_edges(src, dst, ts, te, n_vertices=n_vertices,
                        rng=np.random.default_rng(seed), device=CPU)
    return jg, tg


def _random_graph(rng, n_v, n_e, t_max=200):
    src = rng.integers(0, n_v, n_e)
    dst = rng.integers(0, n_v, n_e)
    ts = rng.integers(0, t_max, n_e)
    te = ts + rng.integers(0, 20, n_e)
    return _graph_pair(src, dst, ts, te, n_vertices=n_v)


def _relax_pair(pred_j=JT.SUCCEEDS, pred_t=TT.SUCCEEDS):
    def jrelax(edges, s):
        return edges.t_end, j_follows(pred_j, s, edges.t_start, edges.t_end)

    def trelax(edges, s):
        return edges.t_end, t_follows(pred_t, s, edges.t_start, edges.t_end)

    return jrelax, trelax


def _eq(want, got):
    a, b = np.asarray(want), as_np(got)
    assert a.shape == b.shape and (a == b).all()


# ---------------------------------------------------------------------------
# test_edgemap.py
# ---------------------------------------------------------------------------

@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000), qlo=st.floats(0.0, 0.95))
def test_scan_index_equivalence(seed, qlo):
    """One round on the scan and the index path: the same combined values,
    each equal to the JAX package's."""
    rng = np.random.default_rng(seed)
    jg, tg = _random_graph(rng, 30, 300)
    ji = jtger.build_tger(jg, degree_cutoff=8, n_time_buckets=8)
    ti = ttger.build_tger(tg, degree_cutoff=8, n_time_buckets=8)
    ts = np.asarray(jg.t_start)
    win = (int(np.quantile(ts, qlo)), int(np.asarray(jg.t_end).max()))
    state = rng.integers(0, 200, 30).astype(np.int32)
    frontier = rng.random(30) < 0.6
    jrelax, trelax = _relax_pair()
    lo_hi = int(((ts >= win[0]) & (ts <= win[1])).sum())
    budget = max(64, 1 << lo_hi.bit_length())
    outs = []
    for method, kw in (("scan", {}), ("index", dict(budget=budget))):
        j_out, _ = jem.temporal_edge_map(
            jg, win, jnp.asarray(frontier), jnp.asarray(state), jrelax, "min",
            tger=ji, plan=jengine.make_plan(method, **kw))
        t_out, _ = tem.temporal_edge_map(
            tg, win, torch.as_tensor(frontier), torch.as_tensor(state), trelax, "min",
            tger=ti, plan=tengine.make_plan(method, **kw))
        _eq(j_out, t_out)
        outs.append(as_np(t_out))
    assert (outs[0] == outs[1]).all()


def test_direction_in():
    rng = np.random.default_rng(7)
    jg, tg = _random_graph(rng, 20, 120)
    win = (0, 10_000)

    def relax(edges, s):
        return edges.t_start, None

    j_out, j_touched = jem.temporal_edge_map(
        jg, win, jnp.ones(20, bool), jnp.zeros(20, jnp.int32),
        lambda e, s: (e.t_start, jnp.ones_like(e.t_start, dtype=bool)), "max",
        direction="in")
    t_out, t_touched = tem.temporal_edge_map(
        tg, win, torch.ones(20, dtype=torch.bool), torch.zeros(20, dtype=torch.int32),
        relax, "max", direction="in")
    _eq(j_out, t_out)
    _eq(j_touched, t_touched)
    # out[u] = max start time of any out-edge of u (reduce into src)
    src, ts = np.asarray(jg.src), np.asarray(jg.t_start)
    expect = np.full(20, np.iinfo(np.int32).min)
    np.maximum.at(expect, src, ts)
    assert (as_np(t_out) == expect).all()


def test_segment_combine_empty_segments():
    vals = torch.as_tensor([5, 3], dtype=torch.int32)
    ids = torch.as_tensor([1, 1])
    out = tem.segment_combine(vals, ids, 4, "min")
    _eq(jem.segment_combine(jnp.asarray([5, 3], jnp.int32), jnp.asarray([1, 1]), 4, "min"),
        out)
    assert int(out[1]) == 3
    assert int(out[0]) == tem.INT_INF  # empty -> identity


def test_frontier_and_planning():
    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, 25, 250), rng.integers(0, 25, 250)
    ts = rng.integers(0, 200, 250)
    jg, tg = _graph_pair(src, dst, ts, ts + rng.integers(0, 20, 250), n_vertices=25)
    ji = jtger.build_tger(jg, degree_cutoff=8)
    ti = ttger.build_tger(tg, degree_cutoff=8)
    f = tem.frontier_from_sources(25, [3, 7], device=CPU)
    assert int(f.sum()) == 2
    _eq(jem.frontier_from_sources(25, [3, 7]), f)
    tsn = np.asarray(jg.t_start)
    win = (int(np.quantile(tsn, 0.99)), int(tsn.max() + 100))
    dec = tengine.decision_for(tg, ti, win, TCost())
    assert dec.method in ("index", "scan")
    assert dec.__dict__ == jengine.decision_for(jg, ji, win, JCost()).__dict__
    assert tengine.decision_for(tg, None, (0, 100)).method == "scan"


# ---------------------------------------------------------------------------
# test_hybrid.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gi():
    jg = jgen.power_law_temporal_graph(150, 6000, seed=31)
    tg = tgen.power_law_temporal_graph(150, 6000, seed=31, device=CPU)
    return (jg, jtger.build_tger(jg, degree_cutoff=64), tg,
            ttger.build_tger(tg, degree_cutoff=64))


def test_partition_covers_all_edges(gi):
    _, _, g, idx = gi
    src = as_np(g.src)
    slot = as_np(idx.vertex_to_slot)
    light = as_np(idx.light_eids)[: idx.n_light_edges]
    assert (slot[src[light]] == -1).all()
    heavy_count = int((slot[src] >= 0).sum())
    assert idx.n_light_edges + heavy_count == g.n_edges


def _valid_set(view, win):
    from repro_torch.core.predicates import in_window

    ok = as_np(view.mask & in_window(view.t_start, view.t_end, win[0], win[1]))
    return sorted(zip(as_np(view.src)[ok].tolist(), as_np(view.dst)[ok].tolist(),
                      as_np(view.t_start)[ok].tolist()))


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_hybrid_view_matches_scan_window_set(gi, q):
    """The set of (edge, window-valid) pairs the hybrid view holds equals
    the scan view's; the budget and the view equal the JAX package's."""
    jg, ji, g, idx = gi
    ts = as_np(g.t_start)
    win = (int(np.quantile(ts, q)), int(as_np(g.t_end).max()))
    kb = tem.hybrid_budget(g, idx, win)
    assert kb == jem.hybrid_budget(jg, ji, win)
    hv = tem.hybrid_view(g, idx, win, kb)
    jhv = jem.hybrid_view(jg, ji, (jnp.int32(win[0]), jnp.int32(win[1])), kb)
    for a, b in zip(jhv, hv):
        _eq(a, b)
    assert _valid_set(hv, win) == _valid_set(tem.scan_view(g), win)


@pytest.mark.parametrize("q", [0.3, 0.95])
def test_hybrid_ea_matches_scan(gi, q):
    jg, ji, g, idx = gi
    ts = as_np(g.t_start)
    win = (int(np.quantile(ts, q)), int(as_np(g.t_end).max()))
    kb = tem.hybrid_budget(g, idx, win)
    src = int(np.argmax(as_np(g.out_degree)))
    a = talg.earliest_arrival(g, src, win)
    b = talg.earliest_arrival(g, src, win, idx,
                              plan=tengine.make_plan("hybrid", per_vertex_budget=kb))
    assert torch.equal(a, b)
    _eq(jalg.earliest_arrival(jg, src, win, ji, plan=jengine.make_plan(
        "hybrid", per_vertex_budget=kb)), b)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 300))
def test_hybrid_property_random_graphs(seed):
    rng = np.random.default_rng(seed)
    n_v, n_e = 40, 400
    jg, g = _graph_pair(rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e),
                        rng.integers(0, 200, n_e), None, n_vertices=n_v, seed=seed)
    idx = ttger.build_tger(g, degree_cutoff=12)
    ts = as_np(g.t_start)
    win = (int(np.quantile(ts, 0.5)), int(as_np(g.t_end).max()))
    kb = tem.hybrid_budget(g, idx, win)
    assert kb == jem.hybrid_budget(jg, jtger.build_tger(jg, degree_cutoff=12), win)
    s = int(rng.integers(0, n_v))
    a = talg.earliest_arrival(g, s, win)
    b = talg.earliest_arrival(g, s, win, idx,
                              plan=tengine.make_plan("hybrid", per_vertex_budget=kb))
    assert torch.equal(a, b)
    _eq(jalg.earliest_arrival(jg, s, win), a)


def test_hybrid_work_reduction_on_selective_window(gi):
    _, _, g, idx = gi
    ts = as_np(g.t_start)
    win = (int(np.quantile(ts, 0.99)), int(as_np(g.t_end).max()))
    kb = tem.hybrid_budget(g, idx, win)
    work = idx.n_light_edges + idx.n_indexed * kb
    assert work < g.n_edges / 2, "hybrid must touch far fewer edge slots"


# ---------------------------------------------------------------------------
# test_tger.py::test_vertex_prefix_strict_vs_nonstrict
# ---------------------------------------------------------------------------

def test_vertex_prefix_strict_vs_nonstrict():
    jg = jgen.power_law_temporal_graph(300, 5000, seed=3)
    g = tgen.power_law_temporal_graph(300, 5000, seed=3, device=CPU)
    off, ts = as_np(g.out_offsets), as_np(g.t_start)
    v = int(np.argmax(off[1:] - off[:-1]))
    sl = ts[off[v]: off[v + 1]]
    bound = int(np.median(sl))
    for strict in (False, True):
        lo, hi = ttger.vertex_prefix(g, v, bound, strict=strict)
        jlo, jhi = jtger.vertex_prefix(jg, v, bound, strict=strict)
        assert (int(lo), int(hi)) == (int(jlo), int(jhi))
        want = (sl < bound).sum() if strict else (sl <= bound).sum()
        assert int(hi) - int(off[v]) == int(want)
    # vectorized over vertices and bounds
    vs = np.arange(0, 300, 7)
    bounds = ts[off[vs]] + 50
    lo, hi = ttger.vertex_prefix(g, torch.as_tensor(vs), torch.as_tensor(bounds))
    jlo, jhi = jtger.vertex_prefix(jg, jnp.asarray(vs), jnp.asarray(bounds))
    _eq(jlo, lo)
    _eq(jhi, hi)


# ---------------------------------------------------------------------------
# test_engine.py::test_pallas_backend_inside_edgemap_min and
# test_fixpoint.py::test_compute_touched_plumbing
# ---------------------------------------------------------------------------

def _engine_graph(seed, n_v, n_e, t_max=200):
    rng = np.random.default_rng(seed)
    return _graph_pair(rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e),
                       rng.integers(0, t_max, n_e), None, n_vertices=n_v, seed=seed)


def test_pallas_backend_inside_edgemap_min():
    """temporal_edge_map routes the min-combine through the tiled path (K1;
    its plain version here) and matches the segment path bit for bit, and
    both match the JAX package's Pallas kernel (interpret mode)."""
    jg, g = _engine_graph(42, 130, 1500)
    ji = jtger.build_tger(jg, degree_cutoff=8)
    ti = ttger.build_tger(g, degree_cutoff=8)
    ts = as_np(g.t_start)
    win = (int(np.quantile(ts, 0.2)), int(as_np(g.t_end).max()))
    rng = np.random.default_rng(0)
    state = rng.integers(0, 200, g.n_vertices).astype(np.int32)
    frontier = rng.random(g.n_vertices) < 0.6
    jrelax, trelax = _relax_pair()
    jp, tp = plans(jg, g, ji, ti, "scan", "pallas_tiled", window=win, tile_v=64,
                   block_e=128)
    out_x, touched_x = tem.temporal_edge_map(
        g, win, torch.as_tensor(frontier), torch.as_tensor(state), trelax, "min",
        plan=tengine.make_plan("scan"))
    out_p, touched_p = tem.temporal_edge_map(
        g, win, torch.as_tensor(frontier), torch.as_tensor(state), trelax, "min",
        plan=tp)
    assert torch.equal(out_x, out_p) and torch.equal(touched_x, touched_p)
    j_out, j_touched = jem.temporal_edge_map(
        jg, win, jnp.asarray(frontier), jnp.asarray(state), jrelax, "min", plan=jp)
    _eq(j_out, out_p)
    _eq(j_touched, touched_p)


def test_compute_touched_plumbing():
    """compute_touched=False skips the segment-sum and returns None; the
    True path is unchanged and equals the JAX package's."""
    jg, g = _engine_graph(3, 40, 300)
    win = (0, 10_000)

    def relax(edges, s):
        return edges.t_end, edges.mask

    frontier = torch.ones(g.n_vertices, dtype=torch.bool)
    state = torch.zeros(g.n_vertices, dtype=torch.int32)
    out_t, touched = tem.temporal_edge_map(g, win, frontier, state, relax, "min",
                                           plan=tengine.make_plan("scan"))
    out_n, none = tem.temporal_edge_map(g, win, frontier, state, relax, "min",
                                        plan=tengine.make_plan("scan"),
                                        compute_touched=False)
    assert none is None
    assert touched is not None and touched.shape == (g.n_vertices,)
    assert torch.equal(out_t, out_n)
    j_out, j_touched = jem.temporal_edge_map(
        jg, win, jnp.ones(g.n_vertices, bool), jnp.zeros(g.n_vertices, jnp.int32),
        relax, "min", plan=jengine.make_plan("scan"))
    _eq(j_out, out_t)
    _eq(j_touched, touched)


# ---------------------------------------------------------------------------
# the primitives alone: an EA loop, single-window and batched
# ---------------------------------------------------------------------------

def _ea_by_primitives(g, tger, source, window, plan):
    """Earliest arrival written with temporal_edge_map, vertex_map and
    frontier_nonempty only."""
    _, relax = _relax_pair()
    V = g.n_vertices
    arrival = torch.full((V,), tem.INT_INF, dtype=torch.int32)
    arrival[source] = window[0]
    frontier = tem.frontier_from_sources(V, [source], device=CPU)
    while bool(tem.frontier_nonempty(frontier)):
        cand, _ = tcore.temporal_edge_map(g, window, frontier, arrival, relax, "min",
                                          tger=tger, plan=plan, compute_touched=False)
        new = torch.minimum(arrival, cand)
        frontier = tcore.vertex_map(new < arrival, lambda v: v < V)
        arrival = new
    return arrival


@pytest.mark.parametrize("access,backend", CELLS)
def test_primitives_ea_loop_equals_earliest_arrival(access, backend):
    """An EA loop over the primitives equals ``earliest_arrival`` under
    the same plan in every plan cell, and the JAX package's; batched, a
    loop over ``temporal_edge_map_batched`` equals
    ``earliest_arrival_batched`` row for row."""
    jg, g = _engine_graph(5, 60, 800)
    ji = jtger.build_tger(jg, degree_cutoff=8)
    ti = ttger.build_tger(g, degree_cutoff=8)
    ts = as_np(g.t_start)
    win = (int(np.quantile(ts, 0.3)), int(as_np(g.t_end).max()))
    _, tp = plans(jg, g, ji, ti, access, backend, window=win)
    source = int(as_np(g.src)[0])
    got = _ea_by_primitives(g, ti, source, win, tp)
    assert torch.equal(got, talg.earliest_arrival(g, source, win, ti, plan=tp))
    _eq(jalg.earliest_arrival(jg, source, win), got)

    wins = np.asarray([win, (win[0], (win[0] + win[1]) // 2), (0, win[1])], np.int32)
    _, tpw = plans(jg, g, ji, ti, access, backend, windows=wins)
    _, relax = _relax_pair()
    V = g.n_vertices
    arrival = torch.full((3, V), tem.INT_INF, dtype=torch.int32)
    arrival[:, source] = torch.as_tensor(wins[:, 0])
    frontier = torch.zeros((3, V), dtype=torch.bool)
    frontier[:, source] = True
    while bool(tem.frontier_nonempty(frontier)):
        cand, touched = tcore.temporal_edge_map_batched(
            g, wins, frontier, arrival, relax, "min", tger=ti, plan=tpw)
        assert touched.shape == (3, V)
        new = torch.minimum(arrival, cand)
        frontier, arrival = new < arrival, new
    assert torch.equal(arrival, talg.earliest_arrival_batched(g, source, wins, ti,
                                                              plan=tpw))


# ---------------------------------------------------------------------------
# the primitives, single-window and batched, against the JAX package's
# ---------------------------------------------------------------------------

# (combine, direction, state, candidate kind): int min/max/sum in both
# directions, a float sum (K3 on a tiled scan plan) and a tuple src_state
CASES = [
    ("min", "out", "tensor", "int"),
    ("min", "in", "tensor", "int"),
    ("sum", "out", "tensor", "int"),
    ("sum", "in", "tensor", "int"),
    ("sum", "out", "tensor", "float"),
    ("max", "in", "tensor", "int"),
    ("min", "out", "tuple", "int"),
]


def _relax_for(xp, follows, pred, combine, state, kind):
    """The same relax for both packages (``xp`` is jnp or torch).  Batched,
    JAX calls it once per window on [K] state, the port once on [W, K]
    state; single-window, both on [K] state."""
    def relax(edges, s):
        if state == "tuple":
            arrival, hops = s
            return hops + 1, follows(pred, arrival, edges.t_start, edges.t_end)
        ok = follows(pred, s, edges.t_start, edges.t_end)
        if kind == "float":
            cast = ((lambda a: a.astype(jnp.float32)) if xp is jnp
                    else (lambda a: a.to(torch.float32)))
            return cast(s) * 0.37 + cast(edges.t_end), ok
        if combine == "sum":
            return s + (edges.t_end - edges.t_start), ok
        return edges.t_end, ok
    return relax


@pytest.mark.parametrize("form", ["batched", "single"])
@pytest.mark.parametrize("combine,direction,state,kind", CASES)
@pytest.mark.parametrize("access,backend", CELLS)
def test_primitives_match_jax(access, backend, combine, direction, state, kind, form):
    """``temporal_edge_map(_batched)`` and ``edge_map_over_view(_batched)``
    give the JAX package's ``combined`` and ``touched`` on the same inputs
    (batched: three windows; single: the first of them): integers bit for
    bit, the float sum within the JAX kernel sweep's tolerance (rtol =
    atol = 2e-4); the views are equal; ``compute_touched=False`` returns
    None and the same ``combined``."""
    jg, g = _engine_graph(9, 70, 900)
    ji = jtger.build_tger(jg, degree_cutoff=8)
    ti = ttger.build_tger(g, degree_cutoff=8)
    ts, te = as_np(g.t_start), as_np(g.t_end)
    wins = np.asarray([(int(np.quantile(ts, 0.3)), int(te.max())),
                       (int(np.quantile(ts, 0.1)), int(np.quantile(te, 0.7))),
                       (0, int(te.max()))], np.int32)
    rng = np.random.default_rng(1)
    V, W = g.n_vertices, len(wins)
    frontiers = rng.random((W, V)) < 0.5
    arrival = rng.integers(0, 200, (W, V)).astype(np.int32)
    hops = rng.integers(0, 10, (W, V)).astype(np.int32)
    if form == "single":
        window = (int(wins[0, 0]), int(wins[0, 1]))
        where, cover = dict(window=window), window
        frontiers, arrival, hops = frontiers[0], arrival[0], hops[0]
        j_map, t_map = jem.temporal_edge_map, tcore.temporal_edge_map
        j_over, t_over = jem.edge_map_over_view, tem.edge_map_over_view
        j_win, t_win = (jnp.int32(window[0]), jnp.int32(window[1])), window
    else:
        where, cover = dict(windows=wins), jem.union_window(wins)
        j_map, t_map = jem.temporal_edge_map_batched, tcore.temporal_edge_map_batched
        j_over, t_over = jem.edge_map_over_view_batched, tem.edge_map_over_view_batched
        j_win, t_win = jnp.asarray(wins), wins
        window = wins
    jp, tp = plans(jg, g, ji, ti, access, backend, tile_v=32, block_e=128, **where)
    j_state = ((jnp.asarray(arrival), jnp.asarray(hops)) if state == "tuple"
               else jnp.asarray(arrival))
    t_state = ((torch.as_tensor(arrival), torch.as_tensor(hops)) if state == "tuple"
               else torch.as_tensor(arrival))
    jrelax = _relax_for(jnp, j_follows, JT.SUCCEEDS, combine, state, kind)
    trelax = _relax_for(torch, t_follows, TT.SUCCEEDS, combine, state, kind)

    def check(want, got):
        a, b = np.asarray(want), as_np(got)
        assert a.shape == b.shape and a.dtype == b.dtype
        if kind == "float":
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)
        else:
            assert (a == b).all()

    kw = dict(direction=direction)
    j_out, j_touched = j_map(jg, window, jnp.asarray(frontiers), j_state, jrelax,
                             combine, tger=ji, plan=jp, **kw)
    t_out, t_touched = t_map(g, window, torch.as_tensor(frontiers), t_state, trelax,
                             combine, tger=ti, plan=tp, **kw)
    check(j_out, t_out)
    _eq(j_touched, t_touched)

    j_view = jem.view_for_plan(jg, ji, cover, jp)
    t_view = tem.view_for_plan(g, ti, tuple(int(x) for x in cover), tp)
    for a, b in zip(j_view, t_view):
        _eq(a, b)
    kw.update(n_vertices=V)
    j_out, j_touched = j_over(j_view, j_win, jnp.asarray(frontiers), j_state, jrelax,
                              combine, plan=jp, **kw)
    t_out, t_touched = t_over(t_view, t_win, torch.as_tensor(frontiers), t_state, trelax,
                              combine, plan=tp, **kw)
    check(j_out, t_out)
    _eq(j_touched, t_touched)
    t_none_out, none = t_over(t_view, t_win, torch.as_tensor(frontiers), t_state, trelax,
                              combine, compute_touched=False, plan=tp, **kw)
    assert none is None and torch.equal(t_none_out, t_out)


def test_vertex_map_and_frontier_nonempty_match_jax():
    rng = np.random.default_rng(4)
    f = rng.random(50) < 0.3

    def keep(v):
        return (v % 3) != 1

    _eq(jem.vertex_map(jnp.asarray(f), keep), tcore.vertex_map(torch.as_tensor(f), keep))
    for frontier in (f, np.zeros(50, bool), rng.random((3, 50)) < 0.1):
        assert (bool(jem.frontier_nonempty(jnp.asarray(frontier)))
                == bool(tem.frontier_nonempty(torch.as_tensor(frontier))))
