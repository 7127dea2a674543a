"""BFS, connected components, k-core (and coreness) and overlaps
reachability in the port against the JAX package, bit for bit, in the six
{scan, index, hybrid} x {xla_segment, pallas_tiled} plan cells on a
power-law and a transit graph, single-window (the batched and over-view
forms are in ``test_torch_batched.py``).  Then the golden checks against
the numpy oracles of ``core/reference.py``.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.core.algorithms as jalg
import repro.core.reference as R
import repro_torch.core.algorithms as talg
import repro_torch.core.tger as ttger
import repro_torch.engine.plan as tplan
from repro_torch.core.edgemap import view_for_plan as tview
from repro_torch.data.generators import synthetic_temporal_graph
from test_torch_common import CELLS, CPU, as_np, assert_same, plans, query_setup

@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access,backend", CELLS)
def test_single_window_plan_cells(kind, access, backend):
    jg, tg, ji, ti, wins, sources = query_setup(kind)
    for w in wins[:2]:
        jp, tp = plans(jg, tg, ji, ti, access, backend, window=w)
        for s in sources:
            assert_same(jalg.temporal_bfs(jg, s, w, ji, plan=jp),
                        talg.temporal_bfs(tg, s, w, ti, plan=tp))
            assert_same(jalg.overlaps_reachability(jg, s, w, ji, plan=jp),
                        talg.overlaps_reachability(tg, s, w, ti, plan=tp))
        assert_same(jalg.temporal_cc(jg, w, ji, plan=jp),
                    talg.temporal_cc(tg, w, ti, plan=tp))
        for k in (2, 4):
            assert_same(jalg.temporal_kcore(jg, k, w, ji, plan=jp),
                        talg.temporal_kcore(tg, k, w, ti, plan=tp))
    assert_same(jalg.temporal_coreness(jg, wins[0], ji, plan=jp, k_max=16),
                talg.temporal_coreness(tg, wins[0], ti, plan=tp, k_max=16))


def test_argument_checks():
    _, tg, _, ti, wins, _ = query_setup("transit")
    rows = np.asarray(wins, np.int32)
    tp = tplan.plan_query(tg, ti, windows=rows, access="scan")
    edges = tview(tg, ti, (int(rows[:, 0].min()), int(rows[:, 1].max())), tp)
    kw = dict(plan=tp, n_vertices=tg.n_vertices)
    with pytest.raises(ValueError, match="scalar source"):
        talg.temporal_bfs_batched(tg, [0, 1], rows, ti)
    with pytest.raises(ValueError, match="warm init"):
        talg.temporal_bfs_over_view(edges, rows, sources=0, init=rows, **kw)
    with pytest.raises(ValueError, match="warm init"):
        talg.temporal_kcore_over_view(edges, rows, k=2, init=rows, **kw)
    with pytest.raises(ValueError, match="source-free"):
        talg.temporal_cc_over_view(edges, rows, sources=0, **kw)
    with pytest.raises(ValueError, match="source-free"):
        talg.temporal_kcore_over_view(edges, rows, k=2, sources=0, **kw)
    with pytest.raises(ValueError, match="needs sources"):
        talg.overlaps_reachability_over_view(edges, rows, **kw)


_GOLDEN = {}


def _golden(seed):
    """The golden graph of ``tests/test_golden_reference.py``, in the port."""
    if seed not in _GOLDEN:
        g = synthetic_temporal_graph(36, 240, seed=seed, device=CPU)
        idx = ttger.build_tger(g, degree_cutoff=8, n_time_buckets=8)
        ts = as_np(g.t_start)
        win = (int(np.quantile(ts, 0.3)), int(as_np(g.t_end).max()))
        cells = {f"{a}/{b}": tplan.plan_query(g, idx, win, access=a, backend=b,
                                              tile_v=16, block_e=32)
                 for a, b in CELLS}
        _GOLDEN[seed] = (g, idx, win, cells, int(as_np(g.src)[seed % g.n_edges]))
    return _GOLDEN[seed]


@pytest.mark.parametrize("seed", [5, 19])
def test_golden_bfs_cc_kcore(seed):
    g, idx, win, cells, src = _golden(seed)
    hops_ref, arr_ref = R.temporal_bfs_ref(g, src, win)
    cc_ref = R.temporal_cc_ref(g, win)
    core_ref = {k: R.temporal_kcore_ref(g, k, win) for k in (2, 3)}
    for name, plan in cells.items():
        hops, arr = talg.temporal_bfs(g, src, win, idx, plan=plan)
        assert (as_np(hops) == hops_ref).all() and (as_np(arr) == arr_ref).all(), name
        assert (as_np(talg.temporal_cc(g, win, idx, plan=plan)) == cc_ref).all(), name
        for k, ref in core_ref.items():
            assert (as_np(talg.temporal_kcore(g, k, win, idx, plan=plan)) == ref).all()
        core = as_np(talg.temporal_coreness(g, win, idx, plan=plan, k_max=8))
        for k in range(1, 9):
            assert ((core >= k) == R.temporal_kcore_ref(g, k, win)).all(), (name, k)


@pytest.mark.parametrize("seed", [5, 19])
def test_golden_reachability_and_betweenness(seed):
    g, idx, win, cells, src = _golden(seed)
    reach_ref = R.overlaps_reachability_ref(g, src, win)
    bc_ref = R.temporal_betweenness_ref(g, [src], win)
    for name, plan in cells.items():
        reach, _, _ = talg.overlaps_reachability(g, src, win, idx, plan=plan)
        # sound (a subset of the oracle's set), and the source reaches itself
        assert (as_np(reach) <= reach_ref).all() and bool(reach[src]), name
        bc = talg.temporal_betweenness(g, [src], win, idx, plan=plan, n_buckets=512)
        np.testing.assert_allclose(as_np(bc), bc_ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
