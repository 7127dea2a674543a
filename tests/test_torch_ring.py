"""Ring-buffer views in the port, mirroring ``test_ring_properties.py``:
an advanced ring view (written in place) equals a cold ring build at the
new window in all six fields, wrap-arounds and the full-capacity shift
included; the ring's masked edge set equals the classic per-window view's;
scan's ring is the graph's own arrays.  Beside those, every ring field
equals the JAX package's slot for slot, cold and advanced, and the
companion delta equals the reference's."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.core.edgemap as jem
import repro.core.temporal_graph as jtg
import repro.core.tger as jtger
import repro_torch.core.edgemap as em
from repro_torch.core.temporal_graph import from_edges
from repro_torch.core.tger import (
    build_tger,
    heavy_window_positions_host,
    window_positions_host,
)
from repro_torch.engine.plan import make_plan, rung
from test_torch_common import as_np

T_MAX = 1000

_GRAPH_CACHE = {}


def _edges(seed, n_v=40, n_e=600):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e),
            rng.integers(0, T_MAX, n_e), n_v)


def _graph(seed):
    """The port's graph and TGER of test_ring_properties.py's case."""
    if seed not in _GRAPH_CACHE:
        src, dst, ts, n_v = _edges(seed)
        g = from_edges(src, dst, ts, None, n_vertices=n_v,
                       rng=np.random.default_rng(seed), device="cpu")
        _GRAPH_CACHE[seed] = (g, build_tger(g, degree_cutoff=8, n_time_buckets=8))
    return _GRAPH_CACHE[seed]


def _jax_graph(seed):
    src, dst, ts, n_v = _edges(seed)
    g = jtg.from_edges(src, dst, ts, None, n_vertices=n_v,
                       rng=np.random.default_rng(seed))
    return g, jtger.build_tger(g, degree_cutoff=8, n_time_buckets=8)


def _views_equal(a, b):
    return all(np.array_equal(as_np(x), as_np(y)) for x, y in zip(a, b))


_METHOD = {
    "index": (window_positions_host, em.index_ring_view, em.advance_index_ring),
    "hybrid": (heavy_window_positions_host, em.hybrid_ring_view,
               em.advance_hybrid_ring),
}
_JAX_METHOD = {
    "index": (jem.index_ring_view, jem.advance_index_ring),
    "hybrid": (jem.hybrid_ring_view, jem.advance_hybrid_ring),
}


def _advance_vs_cold(method, g, idx, w_a, w_b, capacity):
    """(advanced, cold) ring views for the slide w_a -> w_b, or None when
    the server would fall cold (backward slide / overflow)."""
    positions, build, advance = _METHOD[method]
    lo_a, hi_a = positions(idx, w_a)
    lo_b, hi_b = positions(idx, w_b)
    shift = lo_b - lo_a
    if not (0 <= shift <= capacity and hi_a - lo_a <= capacity
            and hi_b - lo_b <= capacity):
        return None
    ring = build(g, idx, lo_a, hi_a, capacity=capacity)
    advanced = advance(g, idx, ring, lo_a, lo_b, hi_b, capacity=capacity)
    assert advanced.src is ring.src  # written in place
    return advanced, build(g, idx, lo_b, hi_b, capacity=capacity)


def _masked_rows(view):
    m = as_np(view.mask)
    return sorted(map(tuple, np.stack([as_np(f)[m] for f in view[:4]], axis=1).tolist()))


# ---------------------------------------------------------------------------
# hypothesis properties
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 4),
    method=st.sampled_from(["index", "hybrid"]),
    lo=st.integers(0, T_MAX - 1),
    width=st.integers(1, T_MAX // 2),
    shift_t=st.integers(0, T_MAX // 2),
    grow=st.integers(-100, 100),
    cap_pow=st.integers(5, 10),
)
def test_ring_advance_bit_identical_to_cold_build(
        seed, method, lo, width, shift_t, grow, cap_pow):
    g, idx = _graph(seed)
    w_a = (lo, lo + width)
    w_b = (lo + shift_t, max(lo + shift_t + 1, lo + shift_t + width + grow))
    pair = _advance_vs_cold(method, g, idx, w_a, w_b, 1 << cap_pow)
    if pair is None:
        return
    assert _views_equal(*pair)


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 4),
    lo=st.integers(0, T_MAX - 1),
    width=st.integers(1, T_MAX // 3),
    cap_pow=st.integers(5, 10),
)
def test_index_ring_set_matches_classic_index_view(seed, lo, width, cap_pow):
    g, idx = _graph(seed)
    capacity = 1 << cap_pow
    w = (lo, lo + width)
    plo, phi = window_positions_host(idx, w)
    if phi - plo > capacity:
        return
    ring = em.index_ring_view(g, idx, plo, phi, capacity=capacity)
    assert _masked_rows(ring) == _masked_rows(em.index_view(g, idx, w, capacity))


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 4),
    lo=st.integers(0, T_MAX - 1),
    width=st.integers(1, T_MAX // 3),
)
def test_hybrid_ring_set_is_light_plus_heavy_in_window(seed, lo, width):
    g, idx = _graph(seed)
    w = (lo, lo + width)
    plo, phi = heavy_window_positions_host(idx, w)
    ring = em.hybrid_ring_view(g, idx, plo, phi, capacity=rung(max(phi - plo, 16)))
    src, ts = as_np(g.src), as_np(g.t_start)
    heavy_src = as_np(idx.vertex_to_slot)[src] >= 0
    want = np.nonzero(~heavy_src | (heavy_src & (ts >= w[0]) & (ts <= w[1])))[0]
    fields = [as_np(f) for f in (g.src, g.dst, g.t_start, g.t_end)]
    want_rows = sorted(map(tuple, np.stack([f[want] for f in fields], axis=1).tolist()))
    assert _masked_rows(ring) == want_rows


# ---------------------------------------------------------------------------
# deterministic cases: wrap-arounds and boundaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["index", "hybrid"])
def test_ring_multi_lap_wraparound_chain(method):
    """Forward slides whose total shift is many laps of a small ring: each
    advanced view equals its cold rebuild, and the JAX package's advanced
    ring slot for slot."""
    g, idx = _graph(0)
    jg, jidx = _jax_graph(0)
    positions, build, advance = _METHOD[method]
    jbuild, jadvance = _JAX_METHOD[method]
    capacity = 32
    windows, t = [], 0
    while t + 40 <= T_MAX:
        windows.append((t, t + 40))
        t += 25
    lo, hi = positions(idx, windows[0])
    assert hi - lo <= capacity
    ring = build(g, idx, lo, hi, capacity=capacity)
    jring = jbuild(jg, jidx, lo, hi, capacity=capacity)
    assert _views_equal(ring, jring)
    total_shift = 0
    for w in windows[1:]:
        lo_n, hi_n = positions(idx, w)
        if hi_n - lo_n > capacity or lo_n - lo > capacity:
            ring, lo, hi = build(g, idx, lo_n, hi_n, capacity=capacity), lo_n, hi_n
            jring = jbuild(jg, jidx, lo_n, hi_n, capacity=capacity)
            continue
        budget = min(rung(max(lo_n - lo, 1)), capacity)
        ring = advance(g, idx, ring, lo, lo_n, hi_n, capacity=capacity)
        jring = jadvance(jg, jidx, jring, lo, lo_n, hi_n, capacity=capacity,
                         delta_budget=budget)
        total_shift += lo_n - lo
        assert _views_equal(ring, build(g, idx, lo_n, hi_n, capacity=capacity)), w
        assert _views_equal(ring, jring), w
        lo, hi = lo_n, hi_n
    assert total_shift > 4 * capacity


@pytest.mark.parametrize("method", ["index", "hybrid"])
def test_ring_full_capacity_shift_boundary(method):
    """shift == capacity replaces every slot in one advance."""
    g, idx = _graph(1)
    positions, build, advance = _METHOD[method]
    capacity = 64
    lo_a, hi_a = positions(idx, (0, 50))
    starts = as_np({"index": idx.start_sorted,
                    "hybrid": idx.heavy_start_sorted}[method])
    lo_b = lo_a + capacity
    if lo_b >= starts.size:
        pytest.skip("graph too small for a full-capacity shift")
    t_b = int(starts[lo_b])
    lo_b2, hi_b = positions(idx, (t_b, t_b + 30))
    if lo_b2 - lo_a != capacity or hi_b - lo_b2 > capacity:
        pytest.skip("no exact full-capacity alignment in this graph")
    ring = build(g, idx, lo_a, hi_a, capacity=capacity)
    advanced = advance(g, idx, ring, lo_a, lo_b2, hi_b, capacity=capacity)
    assert _views_equal(advanced, build(g, idx, lo_b2, hi_b, capacity=capacity))


def test_ring_zero_shift_mask_only_update():
    """A pure window-end change re-masks without writing a slot."""
    g, idx = _graph(2)
    lo, hi = window_positions_host(idx, (100, 300))
    _, hi2 = window_positions_host(idx, (100, 450))
    capacity = rung(max(hi2 - lo, 16))
    ring = em.index_ring_view(g, idx, lo, hi, capacity=capacity)
    before = [f.clone() for f in ring[:5]]
    advanced = em.advance_index_ring(g, idx, ring, lo, lo, hi2, capacity=capacity)
    assert all(np.array_equal(as_np(a), as_np(b)) for a, b in zip(before, advanced[:5]))
    assert _views_equal(advanced, em.index_ring_view(g, idx, lo, hi2, capacity=capacity))


def test_scan_ring_is_the_untouched_full_view():
    g, idx = _graph(3)
    edges, lo, hi, capacity = em.ring_view_for_plan(g, idx, (0, T_MAX), make_plan("scan"))
    assert (lo, hi, capacity) == (-1, -1, 0)
    assert edges.src is g.src  # the graph's own arrays, zero copy


# ---------------------------------------------------------------------------
# against the JAX package, slot for slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("method", ["index", "hybrid"])
def test_ring_fields_equal_jax(seed, method):
    """Cold builds at many windows and capacities, and one advance from
    each, equal the JAX package's ring views in every field; the end of
    the time-first order (clamped positions) included."""
    g, idx = _graph(seed)
    jg, jidx = _jax_graph(seed)
    positions, build, advance = _METHOD[method]
    jbuild, jadvance = _JAX_METHOD[method]
    rng = np.random.default_rng(seed)
    for _ in range(12):
        a = int(rng.integers(0, T_MAX))
        w_a = (a, a + int(rng.integers(1, T_MAX // 3)))
        w_b = (w_a[0] + int(rng.integers(0, 60)), w_a[1] + int(rng.integers(0, 60)))
        capacity = 1 << int(rng.integers(5, 9))
        lo_a, hi_a = positions(idx, w_a)
        lo_b, hi_b = positions(idx, w_b)
        assert (lo_a, hi_a) == (jtger.window_positions_host(jidx, w_a) if method == "index"
                                else jtger.heavy_window_positions_host(jidx, w_a))
        ring = build(g, idx, lo_a, hi_a, capacity=capacity)
        assert _views_equal(ring, jbuild(jg, jidx, lo_a, hi_a, capacity=capacity))
        if not (0 <= lo_b - lo_a <= capacity and hi_b - lo_b <= capacity):
            continue
        jring = jbuild(jg, jidx, lo_a, hi_a, capacity=capacity)
        assert _views_equal(
            advance(g, idx, ring, lo_a, lo_b, hi_b, capacity=capacity),
            jadvance(jg, jidx, jring, lo_a, lo_b, hi_b, capacity=capacity,
                     delta_budget=capacity))


@pytest.mark.parametrize("method", ["index", "hybrid"])
def test_ring_companion_delta_equals_jax(method):
    g, idx = _graph(4)
    jg, jidx = _jax_graph(4)
    positions, build, _ = _METHOD[method]
    capacity = 64
    lo_a, hi_a = positions(idx, (200, 260))
    lo_b, _ = positions(idx, (230, 290))
    perm = idx.perm_by_start if method == "index" else idx.heavy_perm_by_start
    jperm = jidx.perm_by_start if method == "index" else jidx.heavy_perm_by_start
    light = 0 if method == "index" else int(idx.light_eids.shape[0])
    ring = build(g, idx, lo_a, hi_a, capacity=capacity)
    jring = _JAX_METHOD[method][0](jg, jidx, lo_a, hi_a, capacity=capacity)
    got = em.ring_companion_delta(g.src, perm, ring, lo_a, lo_b, capacity=capacity,
                                  light_prefix=light)
    want = jem.ring_companion_delta(jg.src, jperm, jring, lo_a, lo_b,
                                    capacity=capacity, light_prefix=light)
    assert lo_b > lo_a and len(got[0]) == lo_b - lo_a
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and (a == b).all()


def test_ring_view_for_plan_refuses_an_outgrown_pinned_index_plan():
    g, idx = _graph(0)
    lo, hi = window_positions_host(idx, (0, T_MAX))
    with pytest.raises(ValueError, match="ring capacity is 64"):
        em.ring_view_for_plan(g, idx, (0, T_MAX), make_plan("index", budget=64))
    with pytest.raises(ValueError, match=r"lo_new - lo_prev \(40\) <= capacity \(32\)"):
        ring = em.index_ring_view(g, idx, 0, 10, capacity=32)
        em.advance_index_ring(g, idx, ring, 0, 40, 50, capacity=32)
    assert hi - lo > 64
