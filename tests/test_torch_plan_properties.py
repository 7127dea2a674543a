"""The budget properties of ``test_plan_properties.py`` for the port's
planner (hypothesis), each budget also equal to the JAX planner's on the
same graph and window:

  * budgets are monotone in window width (a wider window gets at least
    the rung of a narrower one), for the forced index and the hybrid plan;
  * a ``windows=[...]`` union plan budgets at least as much as every
    member window's own plan (what batched sweeps rely on).

The pytree round-trips of that file test ``jax.tree_util`` and ``jax.jit``
mechanisms; the port's plans are plain dataclasses, and their fields and
cache keys are compared with the JAX plans' in ``test_torch_plan.py``."""
import numpy as np
from hypothesis import given, settings, strategies as st

import repro.core.selective as jsel
import repro.core.temporal_graph as jtg
import repro.core.tger as jtger
import repro.engine.plan as jplan
import repro_torch.core.selective as tsel
import repro_torch.core.temporal_graph as ttg
import repro_torch.core.tger as ttger
import repro_torch.engine.plan as tplan
from test_torch_common import CPU

_CACHE = {}


def _graph(seed, n_v=40, n_e=500, t_max=1000):
    """Both packages' graph and TGER (the reference test's ``_graph``)."""
    if seed not in _CACHE:
        rng = np.random.default_rng(seed)
        edges = (rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e),
                 rng.integers(0, t_max, n_e))
        jg = jtg.from_edges(*edges, None, n_vertices=n_v, rng=np.random.default_rng(seed))
        tg = ttg.from_edges(*edges, None, n_vertices=n_v, rng=np.random.default_rng(seed),
                            device=CPU)
        _CACHE[seed] = (jg, jtger.build_tger(jg, degree_cutoff=8, n_time_buckets=8),
                        tg, ttger.build_tger(tg, degree_cutoff=8, n_time_buckets=8))
    return _CACHE[seed]


def _index_budget(seed, window):
    jg, ji, tg, ti = _graph(seed)
    b = tsel.decide_access(ti, tg.n_edges, window, tsel.CostModel(), force="index").budget
    assert b == jsel.decide_access(ji, jg.n_edges, window, jsel.CostModel(),
                                   force="index").budget
    return b


def _plan(seed, access, **where):
    jg, ji, tg, ti = _graph(seed)
    tp = tplan.plan_query(tg, ti, access=access, **where)
    jp = jplan.plan_query(jg, ji, access=access, **where)
    assert (tp.method, tp.budget, tp.per_vertex_budget, tp.cache_key) == (
        jp.method, jp.budget, jp.per_vertex_budget, jp.cache_key)
    return tp


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 20), lo=st.integers(0, 900), width=st.integers(1, 500),
       extra=st.integers(0, 400))
def test_index_budget_monotone_in_window_width(seed, lo, width, extra):
    """Widening a window (both directions) can only grow the forced-index
    budget rung."""
    narrow = (lo, lo + width)
    wide = (max(lo - extra, 0), lo + width + extra)
    assert _index_budget(seed, wide) >= _index_budget(seed, narrow)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 20), lo=st.integers(0, 900), width=st.integers(1, 500),
       extra=st.integers(0, 400))
def test_hybrid_budget_monotone_in_window_width(seed, lo, width, extra):
    narrow = (lo, lo + width)
    wide = (max(lo - extra, 0), lo + width + extra)
    assert (_plan(seed, "hybrid", window=wide).per_vertex_budget
            >= _plan(seed, "hybrid", window=narrow).per_vertex_budget)


def _assert_union_covers(seed, wins, access):
    union_plan = _plan(seed, access, windows=wins)
    assert union_plan.n_windows == len(wins)
    for w in wins:
        member = _plan(seed, access, window=w)
        # a forced-index plan degenerates to scan when its rung reaches E;
        # a scan union plan covers every member window by definition
        if union_plan.method != "scan":
            assert union_plan.budget >= member.budget
        assert union_plan.per_vertex_budget >= member.per_vertex_budget


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 20),
       bounds=st.lists(st.tuples(st.integers(0, 1000), st.integers(1, 400)),
                       min_size=2, max_size=6),
       access=st.sampled_from(["index", "hybrid"]))
def test_union_plan_budget_covers_member_windows(seed, bounds, access):
    _assert_union_covers(seed, [(lo, lo + w) for lo, w in bounds], access)


def test_union_budget_covers_smoke_without_hypothesis():
    for access in ("index", "hybrid"):
        _assert_union_covers(3, [(0, 100), (200, 900), (500, 600), (50, 350)], access)
