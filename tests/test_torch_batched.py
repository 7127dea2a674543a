"""BFS, connected components, k-core and overlaps reachability, batched
over the union window and over a prebuilt view with per-row sources, in
the port against the JAX package, bit for bit, in the six plan cells on a
power-law and a transit graph; and each batched row against its
single-window run."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.core.algorithms as jalg
import repro_torch.core.algorithms as talg
from repro.core.edgemap import view_for_plan as jview
from repro_torch.core.edgemap import view_for_plan as tview
from test_torch_common import CELLS, assert_same, plans, query_setup


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access,backend", CELLS)
def test_batched_and_over_view_plan_cells(kind, access, backend):
    jg, tg, ji, ti, wins, sources = query_setup(kind)
    rows_w = np.asarray(wins, np.int32)
    jp, tp = plans(jg, tg, ji, ti, access, backend, windows=rows_w)
    s = sources[0]
    assert_same(jalg.temporal_bfs_batched(jg, s, rows_w, ji, plan=jp),
                talg.temporal_bfs_batched(tg, s, rows_w, ti, plan=tp))
    assert_same(jalg.overlaps_reachability_batched(jg, s, rows_w, ji, plan=jp),
                talg.overlaps_reachability_batched(tg, s, rows_w, ti, plan=tp))
    assert_same(jalg.temporal_cc_batched(jg, rows_w, ji, plan=jp),
                talg.temporal_cc_batched(tg, rows_w, ti, plan=tp))
    assert_same(jalg.temporal_kcore_batched(jg, 3, rows_w, ji, plan=jp),
                talg.temporal_kcore_batched(tg, 3, rows_w, ti, plan=tp))

    # per-row sources over one prebuilt view
    rows_w = np.asarray([wins[0], wins[1], wins[0], wins[2]], np.int32)
    rows_s = np.asarray([sources[0], sources[1], sources[1], sources[0]], np.int32)
    jp, tp = plans(jg, tg, ji, ti, access, backend, windows=rows_w)
    union = (int(rows_w[:, 0].min()), int(rows_w[:, 1].max()))
    jv, tv = jview(jg, ji, union, jp), tview(tg, ti, union, tp)
    jkw = dict(plan=jp, n_vertices=jg.n_vertices)
    tkw = dict(plan=tp, n_vertices=tg.n_vertices)
    jw = jnp.asarray(rows_w)
    assert_same(jalg.temporal_bfs_over_view(jv, jw, sources=jnp.asarray(rows_s), **jkw),
                talg.temporal_bfs_over_view(tv, rows_w, sources=rows_s, **tkw))
    reach = jalg.overlaps_reachability_over_view(jv, jw, sources=jnp.asarray(rows_s),
                                                 **jkw)
    assert_same(reach, talg.overlaps_reachability_over_view(tv, rows_w, sources=rows_s,
                                                            **tkw))
    labels = jalg.temporal_cc_over_view(jv, jw, **jkw)
    assert_same(labels, talg.temporal_cc_over_view(tv, rows_w, **tkw))
    assert_same(jalg.temporal_kcore_over_view(jv, jw, k=2, **jkw),
                talg.temporal_kcore_over_view(tv, rows_w, k=2, **tkw))
    # converged warm starts stay put
    assert_same(labels, talg.temporal_cc_over_view(
        tv, rows_w, init=torch.as_tensor(np.array(labels)), **tkw))
    end = np.where(np.asarray(reach[0]), np.asarray(reach[2]), 2**31 - 1)
    start = np.where(np.asarray(reach[0]), np.asarray(reach[1]), 2**31 - 1)
    assert_same(reach, talg.overlaps_reachability_over_view(
        tv, rows_w, sources=rows_s, init=(torch.as_tensor(end), torch.as_tensor(start)),
        **tkw))


def test_batched_rows_equal_single_runs_and_max_rounds():
    jg, tg, ji, ti, wins, sources = query_setup("transit")
    rows_w = np.asarray(wins, np.int32)
    _, tp = plans(jg, tg, ji, ti, "scan", "pallas_tiled", windows=rows_w)
    s = sources[0]
    hops, arr = talg.temporal_bfs_batched(tg, s, rows_w, ti, plan=tp)
    reach = talg.overlaps_reachability_batched(tg, s, rows_w, ti, plan=tp)
    for i, w in enumerate(wins):
        assert_same(talg.temporal_bfs(tg, s, w, ti, plan=tp), (hops[i], arr[i]))
        assert_same(talg.overlaps_reachability(tg, s, w, ti, plan=tp),
                    tuple(r[i] for r in reach))
        assert torch.equal(talg.temporal_cc(tg, w, ti, plan=tp),
                           talg.temporal_cc_batched(tg, rows_w, ti, plan=tp)[i])
    w = wins[0]
    for rounds in (1, 2):
        assert_same(jalg.temporal_bfs(jg, s, w, ji, max_rounds=rounds),
                    talg.temporal_bfs(tg, s, w, ti, max_rounds=rounds))
        assert_same(jalg.overlaps_reachability(jg, s, w, ji, max_rounds=rounds),
                    talg.overlaps_reachability(tg, s, w, ti, max_rounds=rounds))
        assert_same(jalg.temporal_cc(jg, w, ji, max_rounds=rounds),
                    talg.temporal_cc(tg, w, ti, max_rounds=rounds))


