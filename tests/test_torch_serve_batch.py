"""Multi-tenant incremental serving in the port (``serve_batch``,
``sweep_incremental``), mirroring the results-level tests of
``test_multitenant.py`` (all but the sharded and bucketed ones) and of
``test_serving_soak.py``: every advance's rows bit-identical to cold
sweeps (floats within rtol 1e-5 / atol 1e-7), the same ``last_advance``,
``n_solved``, ``n_solved_unique`` and ``warm_applied`` as the JAX engine on
the same stream, one ``fused:<method>`` tag per steady-state advance, the
warm-start soundness table, the moved-from state and the non-consuming
mismatched-state fallback.

What the reference asserts about its traces is not mirrored: the retrace
pinning (``fused_trace_count``) and the donation warnings are mechanisms of
``jax.jit``; the port's advance is eager, and its ring is written in place
(the consumed state raises when passed again)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.engine as je
import repro.serve.window_sweep as jws
import repro_torch.core.edgemap as tem
import repro_torch.engine as te
import repro_torch.serve.window_sweep as ws
from repro.core.reference import overlaps_reachability_ref
from repro_torch.core.algorithms import (
    earliest_arrival,
    earliest_arrival_over_view,
    overlaps_reachability,
    overlaps_reachability_over_view,
    temporal_bfs,
    temporal_bfs_over_view,
    temporal_cc,
    temporal_cc_over_view,
)
from repro_torch.core.edgemap import union_window, view_for_plan
from repro_torch.core.temporal_graph import from_edges
from repro_torch.engine.plan import make_plan, plan_query
from repro_torch.serve import serve_batch, sliding_windows, sweep, sweep_incremental
from test_torch_common import as_np, assert_same, jgen, jtger, tgen, ttger

MT_ADVANCES = 48
SOAK_ADVANCES = 100
FLOAT_ALGS = ("pagerank", "betweenness")
TOL = dict(rtol=1e-5, atol=1e-7)

_CASE = {}


def _case():
    """Both packages' serving case of the reference tests: (jax graph, jax
    index, port graph, port index, top out-degree source, t_min, t_max)."""
    if not _CASE:
        jg = jgen.power_law_temporal_graph(200, 5000, seed=8)
        tg = tgen.power_law_temporal_graph(200, 5000, seed=8, device="cpu")
        ts = as_np(tg.t_start)
        _CASE["v"] = (jg, jtger.build_tger(jg, degree_cutoff=48), tg,
                      ttger.build_tger(tg, degree_cutoff=48),
                      int(np.argmax(as_np(tg.out_degree))), int(ts.min()),
                      int(as_np(tg.t_end).max()))
    return _CASE["v"]


def _counters(state):
    return (state.last_advance, state.n_solved, state.n_solved_unique,
            state.warm_applied)


def _assert_results_match(jres, tres, batch, ctx):
    for gi, (key, _) in enumerate(batch.groups().items()):
        if key[0] in FLOAT_ALGS:
            np.testing.assert_allclose(as_np(tres[gi]), np.asarray(jres[gi]), **TOL,
                                       err_msg=ctx)
        else:
            assert_same(jres[gi], tres[gi])


def _assert_batch_matches_cold(g, idx, batch, results, plan, step):
    """Every row equal to the corresponding cold single-query sweep under
    the same plan (floats allclose)."""
    for gi, ((alg, params), rows) in enumerate(batch.groups().items()):
        res = results[gi]
        for qi, row in enumerate(rows):
            cold = sweep(g, 0 if row.source is None else row.source,
                         np.asarray([row.window], np.int32), idx, algorithm=alg,
                         plan=plan, **dict(params))
            if alg in FLOAT_ALGS:
                np.testing.assert_allclose(as_np(res[qi]), as_np(cold[0]), **TOL,
                                           err_msg=f"step {step}: {alg} row {qi}")
            elif isinstance(res, tuple):
                for i in range(len(res)):
                    assert torch.equal(res[i][qi], cold[i][0]), (step, alg, qi, i)
            else:
                assert torch.equal(res[qi], cold[0]), (step, alg, qi)


# ---------------------------------------------------------------------------
# 1. multi-source row parity
# ---------------------------------------------------------------------------

_PARITY_ALGS = ("earliest_arrival", "bfs", "cc", "reachability")


def _batched_rows(g, alg, sources, wins, plan, idx):
    edges = view_for_plan(g, idx, union_window(wins), plan)
    srcs = torch.as_tensor(np.asarray(sources, np.int64))
    kw = dict(plan=plan, n_vertices=g.n_vertices)
    if alg == "earliest_arrival":
        return (earliest_arrival_over_view(edges, wins, sources=srcs, **kw),)
    if alg == "bfs":
        return temporal_bfs_over_view(edges, wins, sources=srcs, **kw)
    if alg == "cc":
        return (temporal_cc_over_view(edges, wins, **kw),)
    return overlaps_reachability_over_view(edges, wins, sources=srcs, **kw)


def _single_rows(g, alg, sources, wins, plan, idx):
    rows = []
    for s, w in zip(sources, wins):
        win = (int(w[0]), int(w[1]))
        if alg == "earliest_arrival":
            rows.append((earliest_arrival(g, int(s), win, idx, plan=plan),))
        elif alg == "bfs":
            rows.append(temporal_bfs(g, int(s), win, idx, plan=plan))
        elif alg == "cc":
            rows.append((temporal_cc(g, win, idx, plan=plan),))
        else:
            rows.append(overlaps_reachability(g, int(s), win, idx, plan=plan))
    return rows


def _assert_rows_equal(batched, singles, ctx):
    for q, single in enumerate(singles):
        for i, part in enumerate(single):
            assert torch.equal(batched[i][q], part), f"{ctx}: row {q} output {i}"


@pytest.mark.parametrize("alg", _PARITY_ALGS)
@pytest.mark.parametrize("access", ["scan", "index", "hybrid"])
def test_multi_source_rows_match_single_solves(alg, access):
    _, _, g, idx, _, t_min, t_max = _case()
    span = t_max - t_min
    rng = np.random.default_rng(len(alg) * 7 + len(access))
    Q = 5
    sources = rng.integers(0, g.n_vertices, Q)
    starts = rng.integers(t_min, t_max - span // 4, Q)
    widths = rng.integers(max(span // 40, 2), span // 4, Q)
    wins = np.stack([starts, starts + widths], axis=1).astype(np.int32)
    plan = plan_query(g, idx, windows=wins, access=access)
    _assert_rows_equal(_batched_rows(g, alg, sources, wins, plan, idx),
                       _single_rows(g, alg, sources, wins, plan, idx), f"{alg}/{access}")


@settings(max_examples=10, deadline=None)
@given(data=st.data(), alg=st.sampled_from(_PARITY_ALGS),
       access=st.sampled_from(["scan", "index", "hybrid"]))
def test_multi_source_row_parity_property(data, alg, access):
    _, _, g, idx, _, t_min, t_max = _case()
    Q = data.draw(st.integers(1, 6), label="Q")
    sources = [data.draw(st.integers(0, g.n_vertices - 1), label=f"src{i}")
               for i in range(Q)]
    wins = []
    for i in range(Q):
        a = data.draw(st.integers(t_min, t_max - 1), label=f"a{i}")
        wins.append((a, data.draw(st.integers(a + 1, t_max), label=f"b{i}")))
    wins = np.asarray(wins, np.int32)
    plan = plan_query(g, idx, windows=wins, access=access)
    _assert_rows_equal(_batched_rows(g, alg, sources, wins, plan, idx),
                       _single_rows(g, alg, sources, wins, plan, idx), "property")


def test_kcore_without_k_raises_a_clear_error():
    _, _, g, idx, _, t_min, t_max = _case()
    with pytest.raises(ValueError, match="k="):
        sweep(g, 0, np.asarray([[t_min, t_max]], np.int32), idx, algorithm="kcore")


# ---------------------------------------------------------------------------
# 2. the multi-tenant soak, against cold sweeps and the JAX engine
# ---------------------------------------------------------------------------

def _sixteen_query_batch(Q, base, width, stride):
    """test_multitenant.py's 16 rows of mixed algorithms with staggered
    windows, built in package ``Q`` (``repro.engine`` or the port's)."""
    w = lambda off, wd: (int(base - off - wd), int(base - off))  # noqa: E731
    return Q.QueryBatch.make([
        Q.QuerySpec.make("earliest_arrival", w(0, width), sources=[1, 3, 5]),
        Q.QuerySpec.make("earliest_arrival", w(stride, width), sources=1),
        Q.QuerySpec.make("earliest_arrival", w(2 * stride, width), sources=7),
        Q.QuerySpec.make("bfs", w(0, width), sources=[2, 9]),
        Q.QuerySpec.make("bfs", w(stride, width), sources=2),
        Q.QuerySpec.make("cc", w(0, width)),
        Q.QuerySpec.make("cc", w(stride, 2 * width)),
        Q.QuerySpec.make("reachability", w(0, width), sources=[4, 11]),
        Q.QuerySpec.make("reachability", w(stride, width), sources=4),
        Q.QuerySpec.make("kcore", w(0, width), k=2),
        Q.QuerySpec.make("pagerank", w(0, width), n_iters=6),
        Q.QuerySpec.make("pagerank", w(stride, width), n_iters=6),
    ])


@pytest.mark.parametrize("access", ["index", "scan"])
def test_multi_tenant_soak(access):
    """A 16-query mixed batch over many advances (wrapping back to a cold
    start): rows equal to cold sweeps and to the JAX engine's, the same
    advance kinds and counts, and one ``fused:<method>`` per steady-state
    advance."""
    jg, ji, g, idx, _, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 50, 4)
    stride = max(width // 4, 1)
    base0 = t_max - 30 * stride
    base = base0
    rng = np.random.default_rng(1)
    state = jstate = None
    counts = {"cold": 0, "fused": 0}
    for step in range(MT_ADVANCES):
        base += int(rng.integers(1, 3)) * stride
        if base > t_max + width:
            base = base0 + int(rng.integers(0, stride))   # cold trigger
        batch = _sixteen_query_batch(te, base, width, stride)
        assert batch.n_rows == 16
        with ws.dispatch_log() as log:
            results, state = serve_batch(g, batch, idx, state=state, access=access)
        jres, jstate = jws.serve_batch(jg, _sixteen_query_batch(je, base, width, stride),
                                       ji, state=jstate, access=access)
        assert state.plan.cache_key == jstate.plan.cache_key
        assert _counters(state) == _counters(jstate), step
        _assert_results_match(jres, results, batch, f"step {step}")
        _assert_batch_matches_cold(g, idx, batch, results, state.plan, step)
        if state.last_advance == "cold":
            counts["cold"] += 1
        else:
            counts["fused"] += 1
            assert state.last_advance == ("reuse" if access == "scan" else "delta")
            assert log == [f"fused:{access}"], (step, log)
    assert counts["fused"] > 4 * max(counts["cold"], 1), counts


def test_multi_tenant_serving_on_tiled_scan(monkeypatch):
    """The 16-query batch served on scan/``pallas_tiled`` (the tile-min
    kernel's path), a cold start and three advances: counters equal to the
    JAX engine's, integer rows bit-identical and floats within rtol 1e-5.
    Its EA and BFS groups reach the tile-min wrapper with several windows
    at once; on the CPU that is the kernel's plain version."""
    import repro_torch.engine.backends as tb

    jg, ji, g, idx, _, t_min, t_max = _case()
    width = max((t_max - t_min) // 50, 4)
    stride = max(width // 4, 1)
    base = t_max - 30 * stride
    windows_per_call = []
    wrapped = tb.segment_min_tiles

    def counting(dst_local, cand, *args, **kw):
        windows_per_call.append(cand.shape[0] if cand.dim() == 2 else 1)
        return wrapped(dst_local, cand, *args, **kw)

    monkeypatch.setattr(tb, "segment_min_tiles", counting)
    state = jstate = None
    for step in range(4):
        base += stride
        batch = _sixteen_query_batch(te, base, width, stride)
        results, state = serve_batch(g, batch, idx, state=state, access="scan",
                                     backend="pallas_tiled")
        jres, jstate = jws.serve_batch(jg, _sixteen_query_batch(je, base, width, stride),
                                       ji, state=jstate, access="scan",
                                       backend="pallas_tiled")
        assert state.plan.backend == "pallas_tiled"
        assert state.plan.cache_key == jstate.plan.cache_key
        assert _counters(state) == _counters(jstate), step
        assert state.last_advance == ("cold" if step == 0 else "reuse"), step
        _assert_results_match(jres, results, batch, f"step {step}")
    assert max(windows_per_call) > 1, windows_per_call


def test_cross_tenant_row_reuse():
    _, _, g, idx, _, t_min, t_max = _case()
    width = max((t_max - t_min) // 40, 4)
    stride = max(width // 4, 1)
    base = t_min + 4 * width

    def mk(b):
        return te.QueryBatch.make([
            te.QuerySpec.make("earliest_arrival", (b - width, b), sources=1),
            te.QuerySpec.make("earliest_arrival", (b - stride - width, b - stride),
                              sources=1),
        ])

    _, state = serve_batch(g, mk(base), idx, access="index")
    results, state = serve_batch(g, mk(base + stride), idx, state=state, access="index")
    assert state.last_advance == "delta" and state.n_solved == 1
    _assert_batch_matches_cold(g, idx, mk(base + stride), results, state.plan, "reuse")


def test_cross_tenant_dedup_solves_one_row():
    """Two tenants asking the same (source, window) rows solve them once
    and fan them out."""
    _, _, g, idx, _, t_min, t_max = _case()
    width = max((t_max - t_min) // 40, 4)
    b = t_min + 4 * width

    def mk(b):
        return te.QueryBatch.make([
            te.QuerySpec.make("earliest_arrival", (b - width, b), sources=[1, 3]),
            te.QuerySpec.make("earliest_arrival", (b - width, b), sources=[3, 1]),
        ])

    results, state = serve_batch(g, mk(b), idx, access="index")
    assert state.n_solved == 4 and state.n_solved_unique == 2
    results, state = serve_batch(g, mk(b + width // 4), idx, state=state, access="index")
    assert state.last_advance == "delta"
    assert state.n_solved == 4 and state.n_solved_unique == 2
    assert torch.equal(results[0][0], results[0][3])
    _assert_batch_matches_cold(g, idx, mk(b + width // 4), results, state.plan, "dedup")


def test_prefix_shrink_batch_returns_exactly_the_requested_rows():
    _, _, g, idx, _, t_min, t_max = _case()
    span = t_max - t_min
    b = t_min + span // 2
    wins = [(b - span // 8, b), (b - span // 6, b - span // 16),
            (b - span // 4, b - span // 8)]
    mk = lambda ws_: te.QueryBatch.make(  # noqa: E731
        [te.QuerySpec.make("earliest_arrival", w, sources=1) for w in ws_])
    _, state = serve_batch(g, mk(wins), idx, access="index")
    with ws.dispatch_log() as log:
        results, state = serve_batch(g, mk(wins[:2]), idx, state=state, access="index")
    assert state.last_advance == "reorder" and state.n_solved == 0 and log == ["reorder"]
    assert results[0].shape[0] == 2
    _assert_batch_matches_cold(g, idx, mk(wins[:2]), results, state.plan, "prefix")


def test_prefix_shrink_group_in_fused_advance():
    _, _, g, idx, _, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 40, 4)
    stride = max(width // 4, 1)
    b = t_min + span // 2

    def mk(shift, n_cc):
        specs = [te.QuerySpec.make("earliest_arrival", (b + shift - width, b + shift),
                                   sources=1)]
        specs += [te.QuerySpec.make("cc", (b - i * stride - width, b - i * stride))
                  for i in range(n_cc)]
        return te.QueryBatch.make(specs)

    _, state = serve_batch(g, mk(0, 3), idx, access="index")
    results, state = serve_batch(g, mk(stride, 2), idx, state=state, access="index")
    assert state.last_advance == "delta" and state.n_solved == 1
    assert results[1].shape[0] == 2
    _assert_batch_matches_cold(g, idx, mk(stride, 2), results, state.plan, "fused-prefix")


def test_betweenness_serving_row_identity():
    _, _, g, idx, _, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 40, 4)
    stride = max(width // 4, 1)
    base = t_min + span // 2
    kw = dict(n_buckets=16)
    state = None
    for k in range(3):
        wins = sliding_windows(base + k * stride, width=width, stride=stride, count=3)
        res, state = sweep_incremental(g, 1, wins, idx, algorithm="betweenness",
                                       state=state, access="index", warm_start=True, **kw)
        cold = sweep(g, 1, wins, idx, algorithm="betweenness", plan=state.plan, **kw)
        np.testing.assert_allclose(as_np(res), as_np(cold), **TOL)
        if k > 0:
            assert state.last_advance == "delta" and state.n_solved == 1
            assert not state.warm_applied
    b = base + 4 * stride

    def mk(b):
        return te.QueryBatch.make([
            te.QuerySpec.make("betweenness", (b - width, b), sources=1, **kw),
            te.QuerySpec.make("cc", (b - width, b)),
        ])

    _, state = serve_batch(g, mk(b), idx, access="index")
    results, state = serve_batch(g, mk(b + stride), idx, state=state, access="index")
    assert state.last_advance == "delta"
    _assert_batch_matches_cold(g, idx, mk(b + stride), results, state.plan, "betweenness")


def test_serve_batch_mismatched_state_falls_cold_without_consuming():
    _, _, g, idx, _, t_min, t_max = _case()
    span = t_max - t_min
    b = t_min + span // 2
    batch = te.QueryBatch.make(
        [te.QuerySpec.make("earliest_arrival", (b - span // 8, b), sources=1)])
    _, state = serve_batch(g, batch, idx, access="index")
    g2 = tgen.power_law_temporal_graph(150, 2000, seed=9, device="cpu")
    idx2 = ttger.build_tger(g2, degree_cutoff=32)
    batch2 = te.QueryBatch.make([te.QuerySpec.make(
        "earliest_arrival", (int(g2.t_start.min()), int(g2.t_end.max())), sources=1)])
    _, s2 = serve_batch(g2, batch2, idx2, state=state, access="index")
    assert s2.last_advance == "cold" and not state.consumed
    _, s3 = serve_batch(g, batch, idx, state=state, access="index")
    assert s3.last_advance == "noop"


def test_unknown_algorithm_and_options_not_in_the_port():
    """An unknown algorithm raises ValueError; mesh, bucketed admission
    and the cold store raise NotImplementedError naming their ROADMAP
    item, before the carried state is touched."""
    _, _, g, idx, _, t_min, t_max = _case()
    with pytest.raises(ValueError, match="algorithm"):
        serve_batch(g, te.QueryBatch.make(
            [te.QuerySpec.make("nope", (t_min, t_max), sources=1)]), idx)
    b = t_max - (t_max - t_min) // 4
    batch = te.QueryBatch.make(
        [te.QuerySpec.make("earliest_arrival", (b - 50, b), sources=1)])
    _, state = serve_batch(g, batch, idx, access="index")
    for kw, item in ((dict(mesh=2), "item 14"), (dict(admission="bucketed"), "item 13"),
                     (dict(bucket_headroom=4), "item 13"),
                     (dict(coldstore=object()), "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            serve_batch(g, batch, idx, state=state, access="index", **kw)
    with pytest.raises(ValueError, match="admission"):
        serve_batch(g, batch, idx, state=state, admission="eager")
    assert not state.consumed
    _, state = serve_batch(g, batch, idx, state=state, access="index")
    assert state.last_advance == "noop"


def _widening(alg, **params):
    _, _, g, idx, _, t_min, t_max = _case()
    span = t_max - t_min
    lo, mid = t_min, t_min + span // 2
    sources = None if alg in te.SOURCE_FREE else 1
    mk = lambda w: te.QuerySpec.make(alg, w, sources=sources, **params)  # noqa: E731
    return (g, idx, te.QueryBatch.make([mk((lo, mid)), mk((lo + span // 4, mid))]),
            te.QueryBatch.make([mk((lo, mid)), mk((lo + span // 8, mid + span // 8))]))


@pytest.mark.parametrize("alg,applied", [("cc", True), ("earliest_arrival", True),
                                         ("bfs", False)])
def test_warm_start_batch(alg, applied):
    """cc and EA containment warm starts fire and stay bit-identical to the
    cold sweep; bfs's are refused (hop counts are round-indexed)."""
    g, idx, b0, b1 = _widening(alg)
    _, state = serve_batch(g, b0, idx, access="index", warm_start=True)
    with ws.dispatch_log() as log:
        results, state = serve_batch(g, b1, idx, state=state, access="index",
                                     warm_start=True)
    assert state.warm_applied == applied and state.n_solved == 1
    assert log == (["warm-init", "fused:index"] if applied else ["fused:index"])
    _assert_batch_matches_cold(g, idx, b1, results, state.plan, f"{alg}-warm")


# ---------------------------------------------------------------------------
# 3. the single-tenant soak and its properties (test_serving_soak.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["index", "hybrid", "scan"])
def test_long_horizon_soak_bit_identical_every_advance(method):
    """Mixed strides, wrap-arounds and backward jumps: every advance equals
    the cold sweep under the same plan and the JAX engine's rows and
    counters; a k-stride slide solves exactly the k entering windows."""
    jg, ji, g, idx, src, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 50, 4)
    stride = max(width // 4, 1)
    W = 4
    rng = np.random.default_rng(0)
    base0 = t_min + width + (W + 3) * stride
    base = base0
    state = jstate = None
    counts = {"cold": 0, "fused": 0}
    for step in range(SOAK_ADVANCES):
        k = int(rng.integers(1, 4))
        base += k * stride
        wrapped = base > t_max + width
        if wrapped:
            base = base0 + int(rng.integers(0, stride))
        wins = sliding_windows(base, width=width, stride=stride, count=W)
        res, state = sweep_incremental(g, src, wins, idx, state=state, access=method)
        jres, jstate = jws.sweep_incremental(jg, src, wins, ji, state=jstate,
                                             access=method)
        assert torch.equal(res, sweep(g, src, wins, idx, plan=state.plan)), step
        assert_same(jres, res)
        assert _counters(state) == _counters(jstate), step
        if state.last_advance == "cold":
            counts["cold"] += 1
            assert state.n_solved == W
        else:
            counts["fused"] += 1
            assert state.last_advance == ("reuse" if method == "scan" else "delta")
            assert state.n_solved == (W if wrapped else min(k, W)), step
            assert state.last_rounds == int(jstate.last_rounds), step
    assert counts["fused"] > 4 * max(counts["cold"], 1), counts


@pytest.mark.parametrize("method", ["index", "hybrid", "scan"])
def test_steady_state_advance_is_one_dispatch(method):
    _, _, g, idx, src, t_min, t_max = _case()
    span = t_max - t_min
    width, stride, W = max(span // 50, 4), max(span // 200, 1), 5
    base = t_max - 10 * stride
    _, state = sweep_incremental(
        g, src, sliding_windows(base, width=width, stride=stride, count=W), idx,
        access=method)
    _, state = sweep_incremental(
        g, src, sliding_windows(base + stride, width=width, stride=stride, count=W),
        idx, state=state, access=method)
    with ws.dispatch_log() as log:
        res, state = sweep_incremental(
            g, src, sliding_windows(base + 2 * stride, width=width, stride=stride,
                                    count=W), idx, state=state, access=method)
    assert log == [f"fused:{method}"]
    assert state.last_advance == ("reuse" if method == "scan" else "delta")
    assert torch.equal(res, sweep(g, src, state.windows, idx, plan=state.plan))


@pytest.mark.parametrize("method", ["index", "hybrid"])
def test_delta_advance_writes_exactly_the_entering_positions(method, monkeypatch):
    """A delta advance writes lo_new - lo_prev ring slots, no more (the
    reference pads to a delta rung and drops the pad)."""
    _, _, g, idx, src, t_min, t_max = _case()
    span = t_max - t_min
    width, stride = max(span // 50, 4), max(span // 200, 1)
    written = []
    real = tem._scatter_entering
    monkeypatch.setattr(tem, "_scatter_entering", lambda f, p, prev, enter, slots: (
        written.append(int(slots.numel())), real(f, p, prev, enter, slots))[1])
    base = t_min + span // 2
    _, state = sweep_incremental(g, src, sliding_windows(base, width, stride, 3), idx,
                                 access=method)
    deltas = 0
    for k in (1, 2, 3, 1, 2):
        base += k * stride
        lo_prev, ring = state.lo, state.edges
        before = [f.clone() for f in ring[:5]]
        n_written = len(written)
        res, state = sweep_incremental(g, src, sliding_windows(base, width, stride, 3),
                                       idx, state=state, access=method)
        assert torch.equal(res, sweep(g, src, state.windows, idx, plan=state.plan))
        if state.last_advance != "delta":   # the hybrid budget guard replans
            assert method == "hybrid" and len(written) == n_written
            continue
        deltas += 1
        assert state.edges.src is ring.src
        assert written[n_written:] == [state.lo - lo_prev]
        changed = torch.zeros_like(ring.mask)
        for x, y in zip(before, ring[:5]):
            changed |= x != y
        assert int(changed.sum()) <= state.lo - lo_prev
    assert deltas >= 3


def test_identical_windows_are_a_noop():
    _, _, g, idx, src, t_min, t_max = _case()
    span = t_max - t_min
    wins = sliding_windows(t_max, width=max(span // 40, 4), stride=max(span // 80, 1),
                           count=3)
    res0, state = sweep_incremental(g, src, wins, idx, access="index")
    with ws.dispatch_log() as log:
        res1, state = sweep_incremental(g, src, wins, idx, state=state, access="index")
    assert log == [] and state.last_advance == "noop" and state.n_solved == 0
    assert res1 is res0


def test_reordered_windows_reuse_all_rows():
    _, _, g, idx, src, t_min, t_max = _case()
    span = t_max - t_min
    wins = sliding_windows(t_max, width=max(span // 40, 4), stride=max(span // 80, 1),
                           count=4)
    _, state = sweep_incremental(g, src, wins, idx, access="index")
    perm = np.asarray([2, 0, 3, 1])
    res, state = sweep_incremental(g, src, wins[perm], idx, state=state, access="index")
    assert state.last_advance == "reorder" and state.n_solved == 0
    assert torch.equal(res, sweep(g, src, wins[perm], idx, plan=state.plan))


@pytest.mark.parametrize("method", ["index", "scan"])
def test_consumed_state_is_moved_from(method):
    """A state passed to an advance is single-use: passing it again
    raises instead of serving from a ring that has moved on."""
    _, _, g, idx, src, t_min, t_max = _case()
    span = t_max - t_min
    width, stride, W = max(span // 50, 4), max(span // 200, 1), 3
    base = t_max - 10 * stride
    _, state = sweep_incremental(g, src, sliding_windows(base, width, stride, W), idx,
                                 access=method)
    _, nxt = sweep_incremental(g, src, sliding_windows(base + stride, width, stride, W),
                               idx, state=state, access=method)
    assert state.consumed and not nxt.consumed
    with pytest.raises(RuntimeError, match="consumed"):
        sweep_incremental(g, src, sliding_windows(base + 2 * stride, width, stride, W),
                          idx, state=state, access=method)


def _widening_case():
    _, _, g, idx, src, t_min, t_max = _case()
    span = t_max - t_min
    lo, mid = t_min, t_min + span // 2
    wins0 = np.asarray([[lo, mid], [lo + span // 4, mid]], np.int32)
    wins1 = np.asarray([[lo, mid], [lo + span // 8, mid + span // 8]], np.int32)
    return g, idx, src, wins0, wins1


def test_warm_start_defaults_off():
    g, idx, src, wins0, wins1 = _widening_case()
    _, state = sweep_incremental(g, src, wins0, idx, access="index")
    _, state = sweep_incremental(g, src, wins1, idx, state=state, access="index")
    assert not state.warm_applied


def test_warm_start_reachability_sound_containment():
    g, idx, src, wins0, wins1 = _widening_case()
    _, state = sweep_incremental(g, src, wins0, idx, algorithm="reachability",
                                 access="index", warm_start=True)
    res, state = sweep_incremental(g, src, wins1, idx, algorithm="reachability",
                                   state=state, access="index", warm_start=True)
    assert state.warm_applied and state.n_solved == 1
    reach = as_np(res[0])
    for i, w in enumerate(wins1):
        oracle = overlaps_reachability_ref(g, src, (int(w[0]), int(w[1])))
        assert (reach[i] == oracle).all(), i


@pytest.mark.parametrize("algorithm,kw", [("pagerank", dict(n_iters=12)),
                                          ("earliest_arrival", dict(visit_once=True))])
def test_warm_start_refused(algorithm, kw):
    """PageRank (finite iterations) and visit-once EA refuse warm starts;
    the result still matches the cold sweep."""
    g, idx, src, wins0, wins1 = _widening_case()
    _, state = sweep_incremental(g, src, wins0, idx, algorithm=algorithm,
                                 access="index", warm_start=True, **kw)
    res, state = sweep_incremental(g, src, wins1, idx, algorithm=algorithm, state=state,
                                   access="index", warm_start=True, **kw)
    assert not state.warm_applied
    cold = sweep(g, src, wins1, idx, algorithm=algorithm, plan=state.plan, **kw)
    np.testing.assert_allclose(as_np(res), as_np(cold), **TOL)


def _ea_oracle(g, source, window):
    """Host loop mirroring the runner's rounds: (rounds, touched_total)."""
    src, dst = as_np(g.src), as_np(g.dst)
    ts, te_ = as_np(g.t_start), as_np(g.t_end)
    win = (ts >= window[0]) & (te_ <= window[1])
    arrival = np.full(g.n_vertices, np.iinfo(np.int32).max, np.int64)
    arrival[source] = window[0]
    frontier = np.zeros(g.n_vertices, bool)
    frontier[source] = True
    rounds = touched_total = 0
    while frontier.any():
        ok = win & frontier[src] & (arrival[src] <= ts)
        touched_total += np.unique(dst[ok]).size
        new_arrival = arrival.copy()
        np.minimum.at(new_arrival, dst[ok], te_[ok])
        frontier = new_arrival < arrival
        arrival = new_arrival
        rounds += 1
    return rounds, touched_total


@pytest.mark.parametrize("seed", [0, 7, 19])
def test_fixpoint_metrics_match_oracle(seed):
    rng = np.random.default_rng(seed)
    n_v, n_e = 35, 300
    g = from_edges(rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e),
                   rng.integers(0, 200, n_e), None, n_vertices=n_v,
                   rng=np.random.default_rng(seed), device="cpu")
    source = int(rng.integers(0, n_v))
    _, metrics = earliest_arrival(g, source, (20, 180), plan=make_plan("scan"),
                                  with_metrics=True)
    assert (metrics.rounds, metrics.touched_total) == _ea_oracle(g, source, (20, 180))


def test_sweep_incremental_reports_rounds_and_gates_tiny_budgets():
    """Rounds are reported on a delta advance.  The reference's tiny-ring
    cold gate is not in the port (its crossover was calibrated for the
    reference's backend): ``tiny_budget_gate=True`` raises before the
    carried state is touched, and a tiny-ring chain advances by the ring
    delta like any other, bit-identical to the cold sweep."""
    _, _, g, idx, src, t_min, t_max = _case()
    span = t_max - t_min
    width, stride = max(span // 40, 4), max(span // 80, 1)
    _, state = sweep_incremental(g, src, sliding_windows(t_max - stride, width, stride, 3),
                                 idx, access="index")
    _, state = sweep_incremental(g, src, sliding_windows(t_max, width, stride, 3), idx,
                                 state=state, access="index")
    assert state.last_advance == "delta" and state.last_rounds >= 1
    _, tiny = sweep_incremental(g, src, sliding_windows(t_max - 2, 4, 2, 2), idx,
                                access="index")
    assert tiny.capacity <= 64
    with pytest.raises(NotImplementedError, match="tiny_budget_gate"):
        sweep_incremental(g, src, sliding_windows(t_max, 4, 2, 2), idx, state=tiny,
                          access="index", tiny_budget_gate=True)
    assert not tiny.consumed
    wins = sliding_windows(t_max, 4, 2, 2)
    with ws.dispatch_log() as log:
        res, tiny = sweep_incremental(g, src, wins, idx, state=tiny, access="index")
    assert tiny.last_advance == "delta" and log == ["fused:index"]
    assert torch.equal(res, sweep(g, src, wins, idx, plan=tiny.plan))
