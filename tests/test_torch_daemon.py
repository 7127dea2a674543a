"""The serving daemon in the port (bucketed admission on ``serve_batch``,
the ``GraphBatchServer`` submit / retire / tick loop under Poisson churn,
the re-entrant dispatch log, invalidate-on-exception, the graph launcher),
mirroring every result assertion of ``test_daemon.py`` with the port and
the JAX package served side by side: rows (integers exactly, floats within
rtol 1e-5 / atol 1e-7), group capacities, ``rebucket`` tags, the schedule's
static entries, ``GraphServeStats``, ``TickReport.classes_served`` and the
headroom sequences equal.

Not mirrored: ``fused_trace_count`` and every assertion on it (it counts
jit traces; eager torch has none: the schedule's static entries and
``state.group_caps`` stand in for the retrace pinning); the mesh cases
(sharded serving is ROADMAP.md Queue 1 item 14: the port raises
``NotImplementedError``); and the JAX package's legacy module-global
``_DISPATCH_LOG`` hook (the port has only the re-entrant
``dispatch_log``)."""
import re
import types

import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.engine as je
import repro.launch.serve as jlaunch
import repro.serve as jserve
import repro.serve.window_sweep as jws
from repro_torch import obs
import repro_torch.engine as te
import repro_torch.serve as tserve
from repro_torch.engine import DEFAULT_COST_CLASS, bucket_capacity
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import GraphBatchServer, serve_batch
from repro_torch.serve import window_sweep as ws
from test_torch_common import as_np, jgen, jtger, one_rank_group, tgen, ttger

DAEMON_SOAK = 24
ALGS = ("earliest_arrival", "reachability", "bfs", "cc", "pagerank")
FLOAT_ALGS = ("pagerank", "betweenness")
TOL = dict(rtol=1e-5, atol=1e-7)

_CASE = {}


def _case():
    """(port package view, JAX package view, t_min, t_max) on the reference
    tests' graph, with one more vertex: the JAX package's jit cache keys on
    the vertex count, so these JAX serves never warm an entry that
    ``test_daemon.py`` counts as a new trace when both files share a
    worker."""
    if not _CASE:
        jg = jgen.power_law_temporal_graph(201, 5000, seed=8)
        tg = tgen.power_law_temporal_graph(201, 5000, seed=8, device="cpu")
        ts = as_np(tg.t_start)
        port = types.SimpleNamespace(
            g=tg, idx=ttger.build_tger(tg, degree_cutoff=48), e=te, ws=ws,
            serve_batch=serve_batch, Server=GraphBatchServer)
        jax = types.SimpleNamespace(
            g=jg, idx=jtger.build_tger(jg, degree_cutoff=48), e=je, ws=jws,
            serve_batch=jserve.serve_batch, Server=jserve.GraphBatchServer)
        _CASE["v"] = (port, jax, int(ts.min()), int(as_np(tg.t_end).max()))
    return _CASE["v"]


def _spec(p, alg, i, window):
    if alg == "cc":
        return p.e.QuerySpec.make(alg, window)
    if alg == "pagerank":
        return p.e.QuerySpec.make(alg, window, n_iters=6)
    return p.e.QuerySpec.make(alg, window, sources=(7 * i + 1) % 200)


def _tuple(r):
    return r if isinstance(r, tuple) else (r,)


def _assert_rows_match(got, want, alg, ctx):
    """got / want: one group's result (tensor, array or tuple), same rows."""
    got, want = _tuple(got), _tuple(want)
    assert len(got) == len(want), ctx
    for oi, (a, b) in enumerate(zip(got, want)):
        a, b = as_np(a), as_np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{ctx} output {oi}"
        if alg in FLOAT_ALGS:
            np.testing.assert_allclose(a, b, **TOL, err_msg=f"{ctx} output {oi}")
        else:
            assert (a == b).all(), f"{ctx} output {oi} diverged"


def _ea_batch(p, b, width, n):
    return p.e.QueryBatch.make([
        p.e.QuerySpec.make("earliest_arrival", (b - width, b), sources=1 + 3 * i)
        for i in range(n)])


def _pin(p, base, width, stride):
    """The reference soak's plan pinned over the whole slid horizon (ring
    coverage never lapses, so a cold advance is a bucket event)."""
    horizon = p.e.QueryBatch.make([p.e.QuerySpec.make(
        "earliest_arrival", (base - 2 * width, base + 16 * stride), sources=1)])
    return p.e.plan_batch(p.g, p.idx, horizon, access="index")


# ---------------------------------------------------------------------------
# 1. bucketed serve_batch
# ---------------------------------------------------------------------------

def test_bucketed_results_are_padded_to_the_bucket_capacity():
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    b, width = t_min + span // 2, span // 8
    out = []
    for p in (port, jax):
        batch = _ea_batch(p, b, width, 3)
        res_b, state = p.serve_batch(p.g, batch, p.idx, access="index",
                                     admission="bucketed")
        assert state.group_caps == (bucket_capacity(3),) == (4,)
        assert res_b[0].shape[0] == 4          # padded buffer: slice to 3 rows
        res_p, _ = p.serve_batch(p.g, batch, p.idx, access="index", plan=state.plan)
        _assert_rows_match(res_b[0][:3], res_p[0], "earliest_arrival", "bucketed-cold")
        # the pad row replicates the last real row
        _assert_rows_match(res_b[0][3], res_b[0][2], "earliest_arrival", "pad row")
        out.append((res_b[0], state.plan.cache_key))
    _assert_rows_match(out[0][0], out[1][0], "earliest_arrival", "port vs JAX")
    assert out[0][1] == out[1][1]


def test_bucketed_rejects_bad_combos():
    """The unsupported combinations raise a ValueError listing the
    supported ones.  Bucketed admission composes with a mesh, as in the JAX
    package: on one rank, a bucketed sharded serve equals JAX's, padded
    buffer and plan key (``@q1``) included."""
    port, jax, t_min, t_max = _case()
    out = []
    with one_rank_group():
        for p in (port, jax):
            batch = _ea_batch(p, t_max, (t_max - t_min) // 8, 3)
            res, state = p.serve_batch(p.g, batch, p.idx, access="index",
                                       admission="bucketed", mesh=1)
            assert state.group_caps == (4,) and res[0].shape[0] == 4
            out.append((res[0], state.plan.cache_key))
    _assert_rows_match(out[0][0], out[1][0], "earliest_arrival", "bucketed mesh=1")
    assert out[0][1] == out[1][1] and out[0][1].endswith("@q1")
    batch = _ea_batch(port, t_max, (t_max - t_min) // 8, 1)
    with pytest.raises(ValueError, match="warm_start"):
        serve_batch(port.g, batch, port.idx, admission="bucketed", warm_start=True)
    with pytest.raises(ValueError, match="supported serve_batch"):
        serve_batch(port.g, batch, port.idx, admission="sorted")
    with pytest.raises(ValueError, match="admission"):
        serve_batch(port.g, batch, port.idx, admission="sorted")


def test_unsupported_combo_error_path_does_not_consume_state():
    """An unsupported combination raises before the carried state is
    consumed, so the same state object serves right afterwards."""
    port, _, t_min, t_max = _case()
    g, idx = port.g, port.idx
    span = t_max - t_min
    width, stride = max(span // 20, 4), max(span // 160, 1)
    mk = lambda k: _ea_batch(port, t_max - (4 - k) * stride, width, 2)  # noqa: E731
    _, state = serve_batch(g, mk(0), idx, access="index")
    for kw in (dict(admission="rate-limited"),
               dict(admission="bucketed", warm_start=True),
               dict(mesh=(2, 2), access="scan")):     # no group of 4 ranks here
        with pytest.raises(ValueError):
            serve_batch(g, mk(1), idx, state=state, **kw)
    assert not state.consumed
    _, s2 = serve_batch(g, mk(1), idx, state=state, access="index")
    assert s2.last_advance in ("delta", "noop")


def test_within_bucket_admission_keeps_the_schedule():
    """Admitting and retiring rows INSIDE a bucket across slid advances
    never falls cold and keeps the schedule's static entries (the port's
    stand-in for the reference's zero retraces); every advance equals a
    plain serve and the JAX package's bucketed chain."""
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 20, 4)
    stride = max(width // 8, 1)
    base = t_min + span // 2
    counts = (3, 4, 3, 4, 3, 4)
    chains = {}
    for p in (port, jax):
        pin = _pin(p, base, width, stride)
        state, out = None, []
        for k, n in enumerate(counts):
            batch = _ea_batch(p, base + k * stride, width, n)
            results, state = p.serve_batch(p.g, batch, p.idx, state=state,
                                           access="index", plan=pin,
                                           admission="bucketed")
            assert state.group_caps == (4,)
            ref, _ = p.serve_batch(p.g, batch, p.idx, access="index", plan=pin)
            _assert_rows_match(results[0][:n], ref[0], "earliest_arrival",
                               f"adv {k} (n={n})")
            if k > 0:
                assert state.last_advance == "delta", (k, state.last_advance)
                assert state.last_schedule == (
                    ("earliest_arrival", (), "bucket", 4, 4),)
            out.append((as_np(results[0]), state.last_advance, state.last_schedule))
        chains[p is port] = out
    for (a, la, sa), (b, lb, sb) in zip(chains[True], chains[False]):
        _assert_rows_match(a, b, "earliest_arrival", "port vs JAX")
        assert la == lb and sa == sb


def test_bucket_transition_rebuckets_once_then_pins():
    """Growing past the bucket edge costs one ``rebucket`` gather and one
    new schedule entry; the next within-bucket advance keeps it."""
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 20, 4)
    stride = max(width // 8, 1)
    base = t_min + span // 2
    seen = []
    for p in (port, jax):
        pin = _pin(p, base, width, stride)
        state = None
        for k, n in enumerate((4, 4)):
            _, state = p.serve_batch(p.g, _ea_batch(p, base + k * stride, width, n),
                                     p.idx, state=state, access="index", plan=pin,
                                     admission="bucketed")
        sched4 = state.last_schedule
        with p.ws.dispatch_log() as log:
            batch = _ea_batch(p, base + 2 * stride, width, 5)   # 4-bucket -> 8
            results, state = p.serve_batch(p.g, batch, p.idx, state=state,
                                           access="index", plan=pin,
                                           admission="bucketed")
        assert state.group_caps == (8,)
        assert log.count("rebucket") == 1, log
        sched8 = state.last_schedule
        assert sched8 != sched4 and sched8[0][3] == 8
        ref, _ = p.serve_batch(p.g, batch, p.idx, access="index", plan=pin)
        _assert_rows_match(results[0][:5], ref[0], "earliest_arrival", "grow 4->8")
        grown = as_np(results[0])   # the next advance takes JAX's buffers
        with p.ws.dispatch_log() as log2:
            batch = _ea_batch(p, base + 3 * stride, width, 6)
            results2, state = p.serve_batch(p.g, batch, p.idx, state=state,
                                            access="index", plan=pin,
                                            admission="bucketed")
        assert state.group_caps == (8,) and "rebucket" not in log2
        assert state.last_schedule == sched8
        ref, _ = p.serve_batch(p.g, batch, p.idx, access="index", plan=pin)
        _assert_rows_match(results2[0][:6], ref[0], "earliest_arrival", "within 8")
        seen.append((log, log2, sched8, grown, as_np(results2[0])))
    (l1, l2, s, r1, r2), (jl1, jl2, js, jr1, jr2) = seen
    assert (l1, l2, s) == (jl1, jl2, js)
    _assert_rows_match(r1, jr1, "earliest_arrival", "port vs JAX 4->8")
    _assert_rows_match(r2, jr2, "earliest_arrival", "port vs JAX within 8")


def test_bucket_shrink_hysteresis_and_headroom_as_in_jax():
    """The 4x shrink hysteresis and ``bucket_headroom``: capacities follow
    the JAX package's through a grow, a hold, a collapse and a forecast."""
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 20, 4)
    stride = max(width // 8, 1)
    base = t_min + span // 2
    steps = ((9, 0), (5, 0), (3, 0), (2, 0), (2, 6), (3, 6))
    caps = []
    for p in (port, jax):
        pin = _pin(p, base, width, stride)
        state, got = None, []
        for k, (n, hr) in enumerate(steps):
            batch = _ea_batch(p, base + k * stride, width, n)
            results, state = p.serve_batch(p.g, batch, p.idx, state=state,
                                           access="index", plan=pin,
                                           admission="bucketed", bucket_headroom=hr)
            ref, _ = p.serve_batch(p.g, batch, p.idx, access="index", plan=pin)
            _assert_rows_match(results[0][:n], ref[0], "earliest_arrival", f"step {k}")
            got.append((state.group_caps, state.last_advance))
        caps.append(got)
    assert caps[0] == caps[1]
    # 9 -> 16; 5 holds 16 (16 // 4 < 5 <= 16), 3 shrinks to 4, 2 holds 4;
    # 2 + 6 headroom grows to 8; 3 + 6 grows to 16
    assert [c for (c,), _ in caps[0]] == [16, 16, 4, 4, 8, 16]


def test_admission_toggle_falls_cold_without_consuming():
    port, _, t_min, t_max = _case()
    g, idx = port.g, port.idx
    span = t_max - t_min
    b, width = t_min + span // 2, span // 8
    batch = _ea_batch(port, b, width, 3)
    _, st_b = serve_batch(g, batch, idx, access="index", admission="bucketed")
    _, st_p = serve_batch(g, batch, idx, access="index")
    _, s2 = serve_batch(g, batch, idx, state=st_b, access="index")
    assert s2.last_advance == "cold" and not s2.group_caps
    _, s3 = serve_batch(g, batch, idx, state=st_p, access="index",
                        admission="bucketed")
    assert s3.last_advance == "cold" and s3.group_caps
    assert not st_b.consumed and not st_p.consumed
    _, s4 = serve_batch(g, batch, idx, state=st_b, access="index",
                        admission="bucketed")
    assert s4.last_advance == "noop"
    _, s5 = serve_batch(g, batch, idx, state=st_p, access="index")
    assert s5.last_advance == "noop"
    # sweep_incremental refuses a bucketed state the same way
    w = np.asarray([(b - width, b)], np.int32)
    _, s6 = ws.sweep_incremental(g, 1, w, idx, state=st_b, access="index")
    assert s6.last_advance == "cold" and not st_b.consumed


def test_sticky_group_order_returns_results_in_batch_order():
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 20, 4)
    stride = max(width // 8, 1)
    base = t_min + span // 2
    out = []
    for p in (port, jax):
        def mk(b, cc_first):
            ea = p.e.QuerySpec.make("earliest_arrival", (b - width, b), sources=1)
            cc = p.e.QuerySpec.make("cc", (b - width, b))
            return p.e.QueryBatch.make([cc, ea] if cc_first else [ea, cc])

        _, state = p.serve_batch(p.g, mk(base, False), p.idx, access="index",
                                 admission="bucketed")
        assert [k[0] for k in state.group_keys] == ["earliest_arrival", "cc"]
        b2 = base + stride
        results, state = p.serve_batch(p.g, mk(b2, True), p.idx, state=state,
                                       access="index", admission="bucketed")
        assert [k[0] for k in state.group_keys] == ["earliest_arrival", "cc"]
        ref, _ = p.serve_batch(p.g, mk(b2, True), p.idx, access="index",
                               plan=state.plan)
        _assert_rows_match(results[0][:1], ref[0], "cc", "sticky cc group")
        _assert_rows_match(results[1][:1], ref[1], "earliest_arrival",
                           "sticky ea group")
        out.append(tuple(tuple(as_np(x) for x in _tuple(r)) for r in results))
    for a, b, alg in zip(out[0], out[1], ("cc", "earliest_arrival")):
        _assert_rows_match(a, b, alg, "port vs JAX")


# ---------------------------------------------------------------------------
# 2. dispatch_log re-entrancy
# ---------------------------------------------------------------------------

def test_dispatch_log_nested_scopes_both_observe():
    with ws.dispatch_log() as outer:
        obs.note("a")
        with ws.dispatch_log() as inner:
            obs.note("b")
        obs.note("c")
    assert outer == ["a", "b", "c"]
    assert inner == ["b"]
    obs.note("after")                       # no active scope: a no-op
    assert outer == ["a", "b", "c"]


# ---------------------------------------------------------------------------
# 3. the churn soak
# ---------------------------------------------------------------------------

def _soak(p, t_min, t_max):
    """The reference soak's daemon: 25 tenants, seeded Poisson churn,
    ``DAEMON_SOAK`` ticks on a lapping clock.  Returns (server, reports,
    per-tick class-state signatures, live ids, spawned count, lap, pin,
    width)."""
    span = t_max - t_min
    width = max(span // 20, 4)
    stride = max(width // 8, 1)
    lap = max(DAEMON_SOAK // 3, 8)
    base = t_max - (lap + 2) * stride
    horizon = p.e.QueryBatch.make([p.e.QuerySpec.make(
        "earliest_arrival", (base - 2 * width, base + (lap + 2) * stride), sources=1)])
    pin = p.e.plan_batch(p.g, p.idx, horizon, access="index")
    server = p.Server(p.g, p.idx, access="index", plan=pin)
    rng = np.random.default_rng(11)
    live, spawned = [], [0]

    def fresh():
        s = _spec(p, ALGS[spawned[0] % len(ALGS)], spawned[0], (0, width))
        spawned[0] += 1
        return s

    for _ in range(25):
        live.append(server.submit(fresh()))
    reps, sigs = [], []
    for k in range(DAEMON_SOAK):
        if k:
            for _ in range(rng.poisson(0.5)):
                live.append(server.submit(fresh()))
            for _ in range(rng.poisson(0.5)):
                if len(live) > 2:
                    server.retire(live.pop(int(rng.integers(len(live)))))
        cold0 = server.stats.cold_advances
        rep = server.tick(base + (k % lap) * stride)
        sigs.append((tuple(sorted((cls, st.group_keys, st.group_caps)
                                  for cls, st in server._class_states.items())),
                     server.stats.cold_advances - cold0,
                     tuple(sorted((cls, st.last_schedule)
                                  for cls, st in server._class_states.items()))))
        reps.append((rep, {tid: server.tenants[tid] for tid in rep.results}))
    return server, reps, sigs, live, spawned[0], lap, pin


def test_daemon_churn_soak():
    """DAEMON_SOAK ticks of live submit / retire / tick churn: every served
    tenant bit-identical to a cold serve of its instantaneous spec (floats
    allclose) and to the JAX daemon's; the class split; no cold advance and
    an unchanged schedule on ticks whose churn stays inside the buckets
    (after the structure was stable for a lap, the wrap tick excluded);
    stats equal to the JAX daemon's and adding up."""
    port, jax, t_min, t_max = _case()
    server, reps, sigs, live, n_spawned, lap, pin = _soak(port, t_min, t_max)
    jserver, jreps, jsigs, _, _, _, _ = _soak(jax, t_min, t_max)
    g, idx = port.g, port.idx
    expected_advances, caps_sig, last_change, stable = 0, None, 0, 0
    for k, ((rep, specs), (jrep, _)) in enumerate(zip(reps, jreps)):
        assert rep.tick == k + 1 and rep.t_now == jrep.t_now
        assert rep.classes_served == jrep.classes_served
        assert rep.admitted == jrep.admitted and rep.retired == jrep.retired
        expected_advances += len(rep.classes_served)
        classes_live = {s.resolved_cost_class for s in specs.values()}
        if DEFAULT_COST_CLASS in classes_live:
            assert DEFAULT_COST_CLASS in rep.classes_served, rep
        deep_served = [c for c in rep.classes_served if c != DEFAULT_COST_CLASS]
        assert len(deep_served) <= 1
        assert set(rep.results) == set(jrep.results)
        for tid, got in rep.results.items():
            spec = specs[tid]
            w = int(spec.window[1]) - int(spec.window[0])
            inst = te.QuerySpec.make(spec.algorithm, (rep.t_now - w, rep.t_now),
                                     sources=spec.sources or None, **dict(spec.params))
            ref, _ = serve_batch(g, te.QueryBatch.make([inst]), idx, access="index",
                                 plan=pin)
            _assert_rows_match(got, ref[0], spec.algorithm,
                               f"tick {k} tenant {tid} ({spec.algorithm})")
            _assert_rows_match(got, jrep.results[tid], spec.algorithm,
                               f"tick {k} tenant {tid} vs JAX")
        sig, n_cold, sched = sigs[k]
        assert (sig, n_cold, sched) == jsigs[k]
        if sig != caps_sig:
            last_change = k
        if k - last_change > lap and k % lap != 0:
            stable += 1
            assert n_cold == 0, f"tick {k}: within-bucket churn fell cold"
            assert sched == sigs[k - 1][2] or k % lap == 1, (
                f"tick {k}: within-bucket churn changed the schedule")
        caps_sig = sig
    assert stable >= DAEMON_SOAK // 8, f"only {stable} stable ticks"
    s = server.stats
    assert vars(s) == vars(jserver.stats)
    assert s.ticks == DAEMON_SOAK
    assert s.advances == expected_advances
    assert s.admissions == n_spawned
    assert s.retirements == n_spawned - len(live)
    assert len(server.tenants) == len(live)
    assert len(server.latencies) == s.advances
    assert s.dispatches >= s.advances
    assert s.fused_dispatches + s.cold_advances <= s.dispatches


def test_tick_round_robins_multiple_deep_classes():
    """Two deep classes (pagerank + an explicit cost_class override)
    alternate one per tick while the cheap class serves every tick; a
    skipped class's tenants keep their previous answer."""
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 10, 4)
    base = t_min + span // 2
    seen_all, results = [], []
    for p in (port, jax):
        server = p.Server(p.g, p.idx, access="index")
        t_cheap = server.submit(p.e.QuerySpec.make("cc", (0, width)))
        t_pr = server.submit(p.e.QuerySpec.make("pagerank", (0, width), n_iters=4))
        t_slow = server.submit(p.e.QuerySpec.make(
            "bfs", (0, width), sources=3, cost_class="slow-bfs"))
        seen, reps = [], []
        for k in range(4):
            rep = server.tick(base + k)
            assert DEFAULT_COST_CLASS in rep.classes_served
            assert t_cheap in rep.results
            deep = [c for c in rep.classes_served if c != DEFAULT_COST_CLASS]
            assert len(deep) == 1
            seen.append(deep[0])
            if deep[0] == "deep":
                assert t_pr in rep.results and t_slow not in rep.results
            else:
                assert t_slow in rep.results and t_pr not in rep.results
            reps.append(rep)
        assert set(seen) == {"deep", "slow-bfs"} and seen[:2] * 2 == seen
        seen_all.append(seen)
        results.append(reps)
    assert seen_all[0] == seen_all[1]
    algs = {0: "cc", 1: "pagerank", 2: "bfs"}
    for rep, jrep in zip(*results):
        assert set(rep.results) == set(jrep.results)
        for tid in rep.results:
            _assert_rows_match(rep.results[tid], jrep.results[tid], algs[tid],
                               f"tick {rep.tick} tenant {tid}")


def test_rr_survives_deep_class_retirement_mid_rotation():
    port, _, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 10, 4)
    base = t_min + span // 2
    server = GraphBatchServer(port.g, port.idx, access="index")
    tids = {c: server.submit(te.QuerySpec.make(
        "bfs", (0, width), sources=1, cost_class=c)) for c in "abc"}
    served = []
    for k in range(2):
        served += list(server.tick(base + k).classes_served)
    assert served == ["a", "b"]
    server.retire(tids["a"])
    rep = server.tick(base + 2)
    assert list(rep.classes_served) == ["c"], rep.classes_served
    assert list(server.tick(base + 3).classes_served) == ["b"]
    assert list(server.tick(base + 4).classes_served) == ["c"]


def test_admission_forecast_clears_when_class_empties():
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 20, 4)
    base = t_min + span // 2
    hist = []
    for p in (port, jax):
        server = p.Server(p.g, p.idx, access="index")
        burst = [server.submit(_spec(p, "earliest_arrival", i, (0, width)))
                 for i in range(6)]
        server.tick(base)
        seq = [server.bucket_headroom(DEFAULT_COST_CLASS)]
        assert seq[0] >= 6
        for t in burst:
            server.retire(t)
        server.tick(base + 1)                       # the class empties HERE
        assert server.bucket_headroom(DEFAULT_COST_CLASS) == 0
        assert DEFAULT_COST_CLASS not in server._admit_ewma
        server.tick(base + 2)
        server.submit(_spec(p, "earliest_arrival", 0, (0, width)))
        server.tick(base + 3)
        seq.append(server.bucket_headroom(DEFAULT_COST_CLASS))
        assert seq[-1] <= 2
        hist.append((seq, dict(server._admit_ewma)))
    assert hist[0] == hist[1]


def test_arrival_rate_headroom_absorbs_forecasted_bursts():
    """A surprise burst lands with at most one rebucket; once the EWMA has
    learned the burst rate, same-size bursts admit with zero rebuckets.
    The headroom and rebucket sequences equal the JAX daemon's."""
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 20, 4)
    stride = max(width // 8, 1)
    base = t_min + span // 2
    seqs = []
    for p in (port, jax):
        server = p.Server(p.g, p.idx, access="index")
        for i in range(2):
            server.submit(_spec(p, "earliest_arrival", i, (0, width)))
        tick = [0]
        headroom = []

        def run_tick():
            with p.ws.dispatch_log() as log:
                server.tick(base + tick[0] * stride)
            tick[0] += 1
            headroom.append(server.bucket_headroom(DEFAULT_COST_CLASS))
            return log

        for _ in range(5):
            run_tick()
        assert server.bucket_headroom(DEFAULT_COST_CLASS) <= 2
        burst = [server.submit(_spec(p, "earliest_arrival", 10 + i, (0, width)))
                 for i in range(6)]
        log = run_tick()
        assert log.count("rebucket") <= 1, log
        assert server.bucket_headroom(DEFAULT_COST_CLASS) >= 6
        rebuckets = []
        for k in range(7):
            for tid in burst:
                server.retire(tid)
            burst = [server.submit(
                _spec(p, "earliest_arrival", 20 + 10 * k + i, (0, width)))
                for i in range(6)]
            rebuckets.append(run_tick().count("rebucket"))
        assert sum(rebuckets[:3]) <= 1, rebuckets
        assert rebuckets[3:] == [0] * 4, rebuckets
        assert server.bucket_headroom(DEFAULT_COST_CLASS) >= 6
        seqs.append((headroom, rebuckets, vars(server.stats)))
    assert seqs[0] == seqs[1]


def test_retired_tenant_leaves_the_batch():
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 10, 4)
    base = t_min + span // 2
    stats = []
    for p in (port, jax):
        server = p.Server(p.g, p.idx, access="index")
        t1 = server.submit(p.e.QuerySpec.make("cc", (0, width)))
        t2 = server.submit(p.e.QuerySpec.make("earliest_arrival", (0, width), sources=1))
        rep = server.tick(base)
        assert set(rep.results) == {t1, t2} and set(rep.admitted) == {t1, t2}
        server.retire(t2)
        server.retire(999)                       # unknown id: ignored
        rep2 = server.tick(base + 1)
        assert rep2.retired == (t2,)
        assert set(rep2.results) == {t1}
        assert set(server.tenants) == {t1}
        assert server.stats.retirements == 1
        stats.append((vars(server.stats), rep.results, rep2.results))
    assert stats[0][0] == stats[1][0]
    for r, jr in zip(stats[0][1:], stats[1][1:]):
        for tid, alg in ((0, "cc"), (1, "earliest_arrival")):
            if tid in r:
                _assert_rows_match(r[tid], jr[tid], alg, f"tenant {tid}")


# ---------------------------------------------------------------------------
# 4. invalidate-on-exception
# ---------------------------------------------------------------------------

def test_advance_invalidates_state_when_serve_raises(monkeypatch):
    port, jax, t_min, t_max = _case()
    g, idx = port.g, port.idx
    span = t_max - t_min
    b, width = t_min + span // 2, span // 8
    batch = _ea_batch(port, b, width, 2)
    server = GraphBatchServer(g, idx, access="index")
    first = server.advance(batch)
    assert server.state is not None and isinstance(first[0], np.ndarray)
    jserver = jserve.GraphBatchServer(jax.g, jax.idx, access="index")
    jfirst = jserver.advance(_ea_batch(jax, b, width, 2))
    _assert_rows_match(first[0], jfirst[0], "earliest_arrival", "batch mode vs JAX")

    real = ws.serve_batch

    def consuming_boom(g_, batch_, tger_, **kw):
        real(g_, batch_, tger_, **kw)        # consumes the carried state
        raise RuntimeError("post-consumption failure")

    monkeypatch.setattr(ws, "serve_batch", consuming_boom)
    with pytest.raises(RuntimeError, match="post-consumption"):
        server.advance(batch)
    assert server.state is None              # invalidated, not stale
    monkeypatch.undo()

    results = server.advance(batch)          # retry: a clean cold serve
    assert server.state.last_advance == "cold"
    ref, _ = serve_batch(g, batch, idx, access="index", plan=server.state.plan)
    _assert_rows_match(results[0], ref[0], "earliest_arrival", "retry")


def test_tick_invalidates_class_state_when_serve_raises(monkeypatch):
    port, _, t_min, t_max = _case()
    span = t_max - t_min
    width = max(span // 10, 4)
    server = GraphBatchServer(port.g, port.idx, access="index")
    server.submit(te.QuerySpec.make("cc", (0, width)))
    base = t_min + span // 2
    server.tick(base)
    assert "cheap" in server._class_states

    real = ws.serve_batch

    def consuming_boom(g_, batch_, tger_, **kw):
        real(g_, batch_, tger_, **kw)
        raise RuntimeError("tick failure")

    monkeypatch.setattr(ws, "serve_batch", consuming_boom)
    with pytest.raises(RuntimeError, match="tick failure"):
        server.tick(base + 1)
    assert "cheap" not in server._class_states
    monkeypatch.undo()

    rep = server.tick(base + 2)              # recovers cold
    assert rep.results
    assert server._class_states["cheap"].last_advance == "cold"


def test_server_mesh_is_not_in_the_port():
    """``GraphBatchServer(mesh=)`` (once outside the port, hence the name):
    on one rank its batch and daemon modes equal the JAX server's with
    ``mesh=1`` (rows, stats, the class chains' keys); a mesh the process
    group cannot hold raises ValueError at the first serve, as JAX's does."""
    port, jax, t_min, t_max = _case()
    span = t_max - t_min
    width, stride = max(span // 20, 4), max(span // 160, 1)
    runs = []
    with one_rank_group():
        for p in (port, jax):
            server = p.Server(p.g, p.idx, access="index", mesh=1)
            rows = [server.advance(_ea_batch(p, t_max - (3 - k) * stride, width, 2))
                    for k in range(3)]
            daemon = p.Server(p.g, p.idx, access="index", mesh=1)
            for i, alg in enumerate(ALGS):
                daemon.submit(_spec(p, alg, i, (0, width)))
            reps = [daemon.tick(t_max - (3 - k) * stride) for k in range(3)]
            runs.append((rows, vars(server.stats), server.devices, reps,
                         vars(daemon.stats),
                         sorted(st.plan.cache_key
                                for st in daemon._class_states.values())))
    (rows, stats, dev, reps, dstats, keys), (jrows, jstats, jdev, jreps, jdstats,
                                             jkeys) = runs
    assert stats == jstats and dev == jdev == 1 and dstats == jdstats
    assert keys == jkeys and all(k.endswith("@q1") for k in keys)
    for k, (a, b) in enumerate(zip(rows, jrows)):
        _assert_rows_match(a[0], b[0], "earliest_arrival", f"advance {k}")
    alg_of = {i: a for i, a in enumerate(ALGS)}
    for rep, jrep in zip(reps, jreps):
        assert rep.classes_served == jrep.classes_served
        for tid, got in rep.results.items():
            _assert_rows_match(got, jrep.results[tid], alg_of[tid], f"tick {rep.tick}")
    assert GraphBatchServer(port.g, port.idx).devices == 1
    batch = _ea_batch(port, t_max, width, 1)
    with pytest.raises(ValueError, match="no process group"):
        GraphBatchServer(port.g, port.idx, mesh=2).advance(batch)
    with pytest.raises(ValueError, match="device"):
        jax.Server(jax.g, jax.idx, mesh=2).advance(_ea_batch(jax, t_max, width, 1))


# ---------------------------------------------------------------------------
# 5. the daemon on a tiled scan plan (K1's and K3's plain versions)
# ---------------------------------------------------------------------------

def test_daemon_on_tiled_scan_matches_jax():
    """The daemon's cheap class (EA, BFS, CC, reachability) and a deep
    PageRank class on scan/pallas_tiled: K1's and K3's plain versions here,
    the Pallas kernels in interpret mode in the JAX package, three ticks
    with churn: the same classes served, rows and stats."""
    jg = jgen.power_law_temporal_graph(150, 2000, seed=5)
    tg = tgen.power_law_temporal_graph(150, 2000, seed=5, device="cpu")
    ts = as_np(tg.t_start)
    t_min, t_max = int(ts.min()), int(as_np(tg.t_end).max())
    width = (t_max - t_min) // 8
    stride = max(width // 8, 1)
    pkgs = (types.SimpleNamespace(e=te, Server=GraphBatchServer, g=tg,
                                  idx=ttger.build_tger(tg, degree_cutoff=32)),
            types.SimpleNamespace(e=je, Server=jserve.GraphBatchServer, g=jg,
                                  idx=jtger.build_tger(jg, degree_cutoff=32)))
    runs = []
    for p in pkgs:
        server = p.Server(p.g, p.idx, access="scan", backend="pallas_tiled")
        tids = [server.submit(_spec(p, alg, i, (0, width)))
                for i, alg in enumerate(ALGS)]
        reps = []
        for k in range(3):
            if k == 1:
                server.submit(_spec(p, "earliest_arrival", 9, (0, width)))
            if k == 2:
                server.retire(tids[0])
            reps.append(server.tick(t_max - (3 - k) * stride))
        runs.append((reps, vars(server.stats),
                     server._class_states["cheap"].plan.cache_key))
    (reps, stats, key), (jreps, jstats, jkey) = runs
    assert stats == jstats and key == jkey and "pallas_tiled" in key
    alg_of = {i: a for i, a in enumerate(ALGS)} | {5: "earliest_arrival"}
    for rep, jrep in zip(reps, jreps):
        assert rep.classes_served == jrep.classes_served
        assert set(rep.results) == set(jrep.results)
        for tid, got in rep.results.items():
            _assert_rows_match(got, jrep.results[tid], alg_of[tid],
                               f"tick {rep.tick} tenant {tid}")


# ---------------------------------------------------------------------------
# 6. the launcher's graph and daemon modes
# ---------------------------------------------------------------------------

def _numbers(text):
    """The summary lines' integers and ratios, wall-clock figures removed."""
    text = re.sub(r"[\d.]+s\b|\([\d.]+ rows/s\)|[\d.]+ ms", "", text)
    return re.findall(r"\d+(?:\.\d+)?", text)


@pytest.mark.parametrize("mode", ["--graph", "--daemon"])
def test_launcher_matches_jax(mode, capsys):
    """``main([..., mode, "--history-chunks", "64", "--device", "cpu"])``
    returns its stats and prints the JAX launcher's summary lines, the
    same counts and cold-store figures."""
    flags = ["--graph", mode, "--tenants", "6", "--advances", "5", "--ticks", "6",
             "--n-vertices", "300", "--n-edges", "4000", "--history-chunks", "64",
             "--seed", "3"]
    stats = tlaunch.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    jargs = types.SimpleNamespace(
        tenants=6, advances=5, ticks=6, n_vertices=300, n_edges=4000,
        history_chunks=64, history_spill_dir=None, seed=3, shard_queries=None,
        shard_edges=None, arrival_rate=0.5, depart_rate=0.25)
    (jlaunch.run_daemon if mode == "--daemon" else jlaunch.run_graph)(jargs)
    jax_out = capsys.readouterr().out
    assert isinstance(stats, tserve.GraphServeStats)
    n_lines = len(port_out.strip().splitlines())
    assert n_lines == len(jax_out.strip().splitlines()) == (3 if mode == "--daemon" else 2)
    assert _numbers(port_out) == _numbers(jax_out)
    if mode == "--daemon":
        assert f"{stats.ticks} ticks, {stats.advances} class advances" in port_out
        assert "cold store:" in port_out
    else:
        assert "history: tier='cold'" in port_out
        # the stats count the time-travel advance after the summary line
        assert stats.advances == 5 + 1
    # --shard-queries needs a process group of its size ...
    with pytest.raises(ValueError, match="no process group"):
        tlaunch.main(flags + ["--device", "cpu", "--shard-queries", "2"])
    # ... and on one rank serves sharded, printing the JAX launcher's numbers
    # (the cold store turns the mesh off in both, so the flags run without it)
    flags = flags[:flags.index("--history-chunks")] + ["--seed", "3"]
    with one_rank_group():
        stats = tlaunch.main(flags + ["--device", "cpu", "--shard-queries", "1"])
        port_out = capsys.readouterr().out
        jargs.history_chunks, jargs.shard_queries = None, 1
        (jlaunch.run_daemon if mode == "--daemon" else jlaunch.run_graph)(jargs)
        jax_out = capsys.readouterr().out
        with pytest.raises(ValueError, match="needs 2 ranks"):
            tlaunch.main(flags + ["--device", "cpu", "--shard-queries", "2"])
    assert _numbers(port_out) == _numbers(jax_out)
    assert stats.fused_dispatches > 0
