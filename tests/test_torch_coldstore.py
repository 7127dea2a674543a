"""Tiered history in the port (``ColdStore``, the hot/cold/split tier on the
plan, time-travel serving through ``serve_batch`` and the daemon's pinned
history class), mirroring every result assertion of ``test_coldstore.py``
and holding the port to the JAX package on the same graph: chunks (fences,
packed deltas, payload), decodes, stitches, tiers, cache keys and rows
equal (integers exactly, floats within rtol 1e-5 / atol 1e-7), and the
port's tiered rows bit-identical to its own cold full-history solve.

Not mirrored: the soak's ``fused_trace_count`` assertion (it counts jit
traces; eager torch has none).  Its one-dispatch ``fused:index`` tag, the
compaction-on/off parity and the watermark tracking are mirrored."""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.engine as je
import repro.serve as jserve
from repro.core.coldstore import ColdStore as JColdStore
from repro_torch.core.coldstore import ColdStore
from repro_torch.core.edgemap import index_ring_view, ring_view_for_plan
from repro_torch.core.tger import window_positions_host
from repro_torch.engine import QueryBatch, QuerySpec, plan_query
from repro_torch.serve import GraphBatchServer, serve_batch
from repro_torch.serve import window_sweep as ws
from test_torch_common import as_np, jgen, jtger, one_rank_group, tgen, ttger

COLD_SOAK = 16
FLOAT_ALGS = ("pagerank", "betweenness")
TOL = dict(rtol=1e-5, atol=1e-7)
SEVEN = ("earliest_arrival", "reachability", "bfs", "cc", "pagerank", "kcore",
         "betweenness")

_CASE = {}


def _case():
    """Both packages' graph and index of the reference tests: (port graph,
    port index, t_min, t_max, jax graph, jax index)."""
    if not _CASE:
        jg = jgen.power_law_temporal_graph(200, 5000, seed=8)
        tg = tgen.power_law_temporal_graph(200, 5000, seed=8, device="cpu")
        ts = as_np(tg.t_start)
        _CASE["v"] = (tg, ttger.build_tger(tg, degree_cutoff=48), int(ts.min()),
                      int(as_np(tg.t_end).max()), jg,
                      jtger.build_tger(jg, degree_cutoff=48))
    return _CASE["v"]


def _specs(mod, window):
    """The reference's seven-algorithm batch, built with ``mod``'s
    ``QuerySpec`` (the port's or the JAX package's)."""
    out = []
    for i, alg in enumerate(SEVEN):
        if alg == "cc":
            out.append(mod.QuerySpec.make(alg, window))
        elif alg == "kcore":
            out.append(mod.QuerySpec.make(alg, window, k=2))
        elif alg == "pagerank":
            out.append(mod.QuerySpec.make(alg, window, n_iters=6))
        elif alg == "betweenness":
            out.append(mod.QuerySpec.make(alg, window, sources=(3, 11)))
        else:
            out.append(mod.QuerySpec.make(alg, window, sources=(7 * i + 1) % 200))
    return mod.QueryBatch.make(out)


def _tuple(r):
    return r if isinstance(r, tuple) else (r,)


def _assert_identical(got, want, ctx):
    """Row-BIT-identical (floats included): the tiered path replays the
    same solve."""
    got, want = _tuple(got), _tuple(want)
    assert len(got) == len(want), ctx
    for oi, (a, b) in enumerate(zip(got, want)):
        a, b = as_np(a), as_np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx} out {oi}"
        assert (a == b).all(), f"{ctx} output {oi} differs"


def _assert_matches_jax(jres, tres, alg, ctx):
    jres, tres = _tuple(jres), _tuple(tres)
    assert len(jres) == len(tres), ctx
    for oi, (a, b) in enumerate(zip(jres, tres)):
        a, b = np.asarray(a), as_np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{ctx} out {oi}"
        if alg in FLOAT_ALGS:
            np.testing.assert_allclose(b, a, **TOL, err_msg=f"{ctx} out {oi}")
        else:
            assert (a == b).all(), f"{ctx} output {oi} differs from JAX"


def _assert_chunks_equal(jcs, tcs):
    assert tcs.n_chunks == jcs.n_chunks
    for jc, tc in zip(jcs.chunks, tcs.chunks):
        assert (tc.pos_lo, tc.pos_hi, tc.t_lo, tc.t_hi) == (
            jc.pos_lo, jc.pos_hi, jc.t_lo, jc.t_hi)
        for name in ("src", "dst", "dt_start", "dur"):
            a, b = np.asarray(getattr(jc, name)), np.asarray(getattr(tc, name))
            assert a.dtype == b.dtype and (a == b).all(), name
        assert (jc.weight is None) == (tc.weight is None)
        for a, b in zip(jc.decode(), tc.decode()):
            np.testing.assert_array_equal(np.asarray(a), b)


def _span(g):
    ts = as_np(g.t_start)
    return int(ts.min()), int(ts.max() - ts.min())


def _hot_chain(mod, g, idx, cs, *, n=10):
    """Advance a hot index chain (``mod`` is the port's or the JAX
    package's serving module) far enough that compaction sealed chunks;
    returns (state, last_base, width, stride, last results)."""
    t_min, span = _span(g)
    width = max(span // 40, 1)
    stride = max(span // 200, 1)
    base = t_min + span // 2
    state = res = None
    qmod = QueryBatch if mod is ws else je.QueryBatch
    smod = QuerySpec if mod is ws else je.QuerySpec
    for k in range(n):
        batch = qmod.make([smod.make(
            "earliest_arrival", (base + k * stride - width, base + k * stride),
            sources=3)])
        res, state = mod.serve_batch(g, batch, idx, state=state, access="index",
                                     coldstore=cs)
    return state, base + (n - 1) * stride, width, stride, res


# ---------------------------------------------------------------------------
# 1. ColdStore unit behavior
# ---------------------------------------------------------------------------

def test_eviction_seals_chunks_with_time_fences():
    g, idx, *_, jg, ji = _case()
    cs, jcs = ColdStore(g, idx, chunk_slots=128), JColdStore(jg, ji, chunk_slots=128)
    assert cs.watermark == 0 and cs.n_chunks == 0
    added = cs.note_eviction(300)
    assert added == jcs.note_eviction(300) == 300 and cs.n_chunks == 2
    assert cs.watermark == 300
    assert cs.pending_slots == 300 - 2 * 128
    starts = as_np(g.t_start)[as_np(idx.perm_by_start)]
    for ci, ch in enumerate(cs.chunks):
        assert (ch.pos_lo, ch.pos_hi) == (ci * 128, (ci + 1) * 128)
        seg = starts[ch.pos_lo:ch.pos_hi]
        assert ch.t_lo == int(seg[0])
        assert ch.t_hi == int(starts[ch.pos_hi]) > int(seg[-1])   # exclusive fence
    # monotone: a stale (smaller) eviction note is a no-op
    assert cs.note_eviction(200) == jcs.note_eviction(200) == 0
    assert cs.watermark == 300
    _assert_chunks_equal(jcs, cs)
    assert cs.stats() == jcs.stats()


def test_chunk_decode_is_bit_exact():
    g, idx, *_, jg, ji = _case()
    cs, jcs = ColdStore(g, idx, chunk_slots=256), JColdStore(jg, ji, chunk_slots=256)
    cs.note_eviction(1024)
    jcs.note_eviction(1024)
    perm = as_np(idx.perm_by_start)
    for ch in cs.chunks:
        eids = perm[ch.pos_lo:ch.pos_hi]
        src, dst, t_start, t_end, weight = ch.decode()
        np.testing.assert_array_equal(src, as_np(g.src)[eids])
        np.testing.assert_array_equal(dst, as_np(g.dst)[eids])
        np.testing.assert_array_equal(t_start, as_np(g.t_start)[eids])
        np.testing.assert_array_equal(t_end, as_np(g.t_end)[eids])
        np.testing.assert_array_equal(weight, as_np(g.weight)[eids])
    _assert_chunks_equal(jcs, cs)
    # the last chunk's fence at the end of the stream is INT32_MAX
    end = ColdStore(g, idx, chunk_slots=1000)
    end.note_eviction(g.n_edges)
    assert end.chunks[-1].t_hi == np.iinfo(np.int32).max


def test_directory_lookup_by_fences():
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    cs, jcs = ColdStore(g, idx, chunk_slots=128), JColdStore(jg, ji, chunk_slots=128)
    cs.note_eviction(1024)
    jcs.note_eviction(1024)
    win = (t_min + span // 16, t_min + span // 8)
    touched = {ch.pos_lo for ch in cs.chunks_for(win)}
    for ch in cs.chunks:
        overlaps = ch.t_lo < win[1] and ch.t_hi > win[0]
        assert (ch.pos_lo in touched) == overlaps
    assert touched == {ch.pos_lo for ch in jcs.chunks_for(win)}
    assert cs.chunks_for((t_max + 1, t_max + 10)) == []


def test_ring_stitch_matches_index_ring_view_bitwise():
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    cs, jcs = ColdStore(g, idx, chunk_slots=256), JColdStore(jg, ji, chunk_slots=256)
    cs.note_eviction(900)                       # sealed chunks + pending tail
    jcs.note_eviction(900)
    for frac in (16, 8, 5, 2):                  # 1/2 reaches the unsealed suffix
        win = (t_min + span // frac, t_min + span // frac + span // 10)
        p_lo, p_hi = window_positions_host(idx, win)
        cap = 1 << max(int(np.ceil(np.log2(max(p_hi - p_lo, 1)))), 4)
        ref = index_ring_view(g, idx, p_lo, p_hi, capacity=cap)
        fields, mask, lo, hi = cs.ring_stitch(win, cap)
        jfields, jmask, jlo, jhi = jcs.ring_stitch(win, cap)
        assert (lo, hi) == (p_lo, p_hi) == (jlo, jhi)
        for name, a, b in zip(("src", "dst", "t_start", "t_end", "weight"), fields,
                              jfields):
            assert torch.equal(torch.from_numpy(a), getattr(ref, name)), (name, frac)
            assert a.dtype == np.asarray(b).dtype and (a == np.asarray(b)).all()
        assert torch.equal(torch.from_numpy(mask), ref.mask)
        np.testing.assert_array_equal(mask, np.asarray(jmask))
    with pytest.raises(ValueError, match="capacity"):
        cs.ring_stitch((t_min, t_max + 1), 16)  # span cannot fit


def test_classify_tiers():
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    cs, jcs = ColdStore(g, idx, chunk_slots=256), JColdStore(jg, ji, chunk_slots=256)
    cs.note_eviction(1000)
    jcs.note_eviction(1000)
    starts = as_np(g.t_start)[as_np(idx.perm_by_start)]
    t_wm = int(starts[1000])
    cases = [((t_wm + 1, t_max), None, "hot"),
             ((t_min, t_wm - span // 50), None, "cold"),
             ((t_min, t_max), None, "split"),
             # hot_lo override: a chain whose own ring still holds older positions
             ((t_min + span // 4, t_max), 0, "hot")]
    for win, hot_lo, want in cases:
        assert cs.classify(win, hot_lo=hot_lo) == jcs.classify(win, hot_lo=hot_lo) == want


# ---------------------------------------------------------------------------
# 2. time-travel correctness: seven algorithms, cold and split windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cold", "split"])
def test_time_travel_bit_identical_all_seven(kind):
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    cs, jcs = ColdStore(g, idx, chunk_slots=256), JColdStore(jg, ji, chunk_slots=256)
    state, *_ = _hot_chain(ws, g, idx, cs)
    jstate, *_ = _hot_chain(jserve.window_sweep, jg, ji, jcs)
    assert cs.watermark == state.lo == jcs.watermark > 0
    _assert_chunks_equal(jcs, cs)
    starts = as_np(g.t_start)[as_np(idx.perm_by_start)]
    t_wm = int(starts[cs.watermark])
    if kind == "cold":
        win = (t_min + span // 16, min(t_wm - 1, t_min + span // 4))
    else:
        win = (t_min + span // 4, t_wm + span // 40)
    batch = _specs(ws, win)
    with ws.dispatch_log() as log:
        res, hstate = serve_batch(g, batch, idx, access="index", coldstore=cs)
    assert log[0] == "cold:stitch"
    assert hstate.plan.tier == kind and hstate.plan.method == "index"
    # the reference: the SAME tier plan served WITHOUT a cold store, a cold
    # full-history build off the graph's tensors
    ref, _ = serve_batch(g, batch, idx, plan=hstate.plan)
    jres, jh = jserve.serve_batch(jg, _specs(je, win), ji, access="index",
                                  coldstore=jcs)
    assert jh.plan.cache_key == hstate.plan.cache_key
    for gi, key in enumerate(batch.groups()):
        _assert_identical(res[gi], ref[gi], f"{kind}:{key[0]}")
        _assert_matches_jax(jres[gi], res[gi], key[0], f"{kind}:{key[0]}")
    # and the repeat serve is the noop path
    res2, hstate2 = serve_batch(g, batch, idx, state=hstate, access="index",
                                coldstore=cs)
    assert hstate2.last_advance == "noop"
    for gi, key in enumerate(batch.groups()):
        _assert_identical(res2[gi], ref[gi], f"{kind}:noop:{key[0]}")


def test_tier_switch_never_consumes_hot_state():
    """Serving a historical window between hot advances does not consume
    the hot chain's state: the next hot advance is still a delta."""
    g, idx, *_ = _case()
    cs = ColdStore(g, idx, chunk_slots=256)
    state, last_base, width, stride, _ = _hot_chain(ws, g, idx, cs)
    t_min, span = _span(g)
    hist = QueryBatch.make(
        [QuerySpec.make("cc", (t_min + span // 16, t_min + span // 8))])
    _, hstate = serve_batch(g, hist, idx, access="index", coldstore=cs)
    assert hstate.plan.tier in ("cold", "split")
    # a hot state offered with a historical batch falls cold, unconsumed
    _, h2 = serve_batch(g, hist, idx, state=state, access="index", coldstore=cs)
    assert h2.plan.tier == hstate.plan.tier and not state.consumed
    nxt = QueryBatch.make(
        [QuerySpec.make("earliest_arrival",
                        (last_base + stride - width, last_base + stride), sources=3)])
    with ws.dispatch_log() as log:
        _, state = serve_batch(g, nxt, idx, state=state, access="index", coldstore=cs)
    assert state.last_advance == "delta" and log == ["fused:index"]


# ---------------------------------------------------------------------------
# 3. the horizon: error BEFORE the carried state is consumed
# ---------------------------------------------------------------------------

def test_out_of_horizon_pinned_plan_raises_naming_horizon():
    g, idx, t_min, t_max, *_ = _case()
    span = t_max - t_min
    base = t_min + span // 2
    width = max(span // 40, 1)
    plan = plan_query(g, idx, windows=[(base - width, base)], access="index")
    hist = (t_min, t_min + span // 2)           # far wider than the plan
    p_lo, p_hi = window_positions_host(idx, hist)
    assert p_hi - p_lo > (plan.ring_capacity or plan.budget)
    with pytest.raises(ValueError, match="horizon"):
        ring_view_for_plan(g, idx, hist, plan)


def test_out_of_horizon_error_leaves_state_advanceable():
    g, idx, t_min, t_max, *_ = _case()
    span = t_max - t_min
    width = max(span // 40, 1)
    stride = max(span // 200, 1)
    base = t_min + span // 2

    def mk(b):
        return QueryBatch.make(
            [QuerySpec.make("earliest_arrival", (b - width, b), sources=3)])

    plan = plan_query(g, idx, windows=[(base - width, base)], access="index")
    state = None
    for k in range(3):
        _, state = serve_batch(g, mk(base + k * stride), idx, state=state, plan=plan)
    assert state.last_advance == "delta"
    hist = (t_min, t_min + span // 2)
    p_lo, p_hi = window_positions_host(idx, hist)
    assert p_hi - p_lo > (plan.ring_capacity or plan.budget)
    with pytest.raises(ValueError, match="horizon"):
        serve_batch(g, QueryBatch.make(
            [QuerySpec.make("earliest_arrival", hist, sources=3)]),
            idx, state=state, plan=plan)
    # the raise came before the carried ring was written: the SAME state
    # advances warm
    assert not state.consumed
    _, state = serve_batch(g, mk(base + 3 * stride), idx, state=state, plan=plan)
    assert state.last_advance == "delta"


def test_unplanned_history_without_coldstore_still_serves():
    """WITHOUT a pinned plan there is no horizon to violate: the planner
    builds a covering view (tier stays "hot" with no cold store)."""
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    win = (t_min + span // 16, t_min + span // 8)
    batch = QueryBatch.make([QuerySpec.make("cc", win)])
    res, st = serve_batch(g, batch, idx, access="index")
    assert st.plan.tier == "hot"
    ref, _ = serve_batch(g, batch, idx, plan=st.plan)
    _assert_identical(res[0], ref[0], "legacy-history")
    jres, _ = jserve.serve_batch(jg, je.QueryBatch.make([je.QuerySpec.make("cc", win)]),
                                 ji, access="index")
    _assert_matches_jax(jres[0], res[0], "cc", "legacy-history")


def test_cold_tier_refuses_fused_only_combos_before_state():
    g, idx, t_min, t_max, *_ = _case()
    span = t_max - t_min
    cs = ColdStore(g, idx, chunk_slots=256)
    state, *_ = _hot_chain(ws, g, idx, cs)
    hist = QueryBatch.make(
        [QuerySpec.make("cc", (t_min + span // 16, t_min + span // 8))])
    for kw in (dict(admission="bucketed"), dict(warm_start=True)):
        with pytest.raises(ValueError, match="cold tier"):
            serve_batch(g, hist, idx, access="index", coldstore=cs, **kw)
    # a below-horizon batch refuses any mesh with the reference's
    # ValueError (the mesh needs a process group: one rank here)
    with one_rank_group():
        with pytest.raises(ValueError, match="cold tier.*mesh=None"):
            serve_batch(g, hist, idx, access="index", coldstore=cs, mesh=1)
    _, _, _, _, jg, ji = _case()
    jcs = JColdStore(jg, ji, chunk_slots=256)
    _hot_chain(jserve, jg, ji, jcs)
    jhist = je.QueryBatch.make(
        [je.QuerySpec.make("cc", (t_min + span // 16, t_min + span // 8))])
    with pytest.raises(ValueError, match="cold tier.*mesh=None"):
        jserve.serve_batch(jg, jhist, ji, access="index", coldstore=jcs, mesh=1)
    with pytest.raises(ValueError, match="TGER"):
        serve_batch(g, hist, None, coldstore=cs)
    # none of those raises consumed the hot chain's state
    t_min2, span2 = _span(g)
    width = max(span2 // 40, 1)
    stride = max(span2 // 200, 1)
    base = t_min2 + span2 // 2 + 9 * stride
    nxt = QueryBatch.make(
        [QuerySpec.make("earliest_arrival",
                        (base + stride - width, base + stride), sources=3)])
    _, state = serve_batch(g, nxt, idx, state=state, access="index", coldstore=cs)
    assert state.last_advance == "delta"


# ---------------------------------------------------------------------------
# 4. the compaction soak
# ---------------------------------------------------------------------------

def test_compaction_soak_one_dispatch_zero_retrace_parity():
    """COLD_SOAK advances with and without compaction: one ``fused:index``
    tag per advance after warmup, rows bit-identical between the chains and
    equal to the JAX chain's, the store's watermark on the ring's low
    watermark and equal to the JAX store's every advance."""
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    width = max(span // 40, 1)
    stride = max(span // (COLD_SOAK * 4), 1)
    base = t_min + span // 3
    cs, jcs = ColdStore(g, idx, chunk_slots=256), JColdStore(jg, ji, chunk_slots=256)

    def mk(mod, b):
        return mod.QueryBatch.make([
            mod.QuerySpec.make("earliest_arrival", (b - width, b), sources=3),
            mod.QuerySpec.make("cc", (b - width, b)),
        ])

    state_on = state_off = jstate = None
    warmup = 2
    for k in range(COLD_SOAK):
        b = base + k * stride
        with ws.dispatch_log() as log_off:
            res_off, state_off = serve_batch(g, mk(ws, b), idx, state=state_off,
                                             access="index")
        with ws.dispatch_log() as log_on:
            res_on, state_on = serve_batch(g, mk(ws, b), idx, state=state_on,
                                           access="index", coldstore=cs)
        jres, jstate = jserve.serve_batch(jg, mk(je, b), ji, state=jstate,
                                          access="index", coldstore=jcs)
        if k >= warmup:
            assert log_on == ["fused:index"], (k, log_on)
            assert log_on == log_off
        for gi, alg in enumerate(("earliest_arrival", "cc")):
            _assert_identical(res_on[gi], res_off[gi], f"advance {k}")
            _assert_matches_jax(jres[gi], res_on[gi], alg, f"advance {k}")
        assert cs.watermark == max(state_on.lo, 0) == jcs.watermark
        assert state_on.last_advance == jstate.last_advance
    assert cs.n_chunks > 0, "the soak never sealed a chunk"
    assert cs.stats()["compaction_ratio"] > 1.0
    assert cs.stats() == jcs.stats()
    _assert_chunks_equal(jcs, cs)


# ---------------------------------------------------------------------------
# 5. daemon integration: the pinned history class
# ---------------------------------------------------------------------------

def test_daemon_pinned_tenant_serves_history_verbatim():
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    width = max(span // 40, 1)
    stride = max(span // 200, 1)
    base = t_min + span // 2
    hist_win = (t_min + span // 16, t_min + span // 16 + width)
    servers = []
    for mod, gg, ii, store in ((None, g, idx, ColdStore), (je, jg, ji, JColdStore)):
        cs = store(gg, ii, chunk_slots=256)
        cls = GraphBatchServer if mod is None else jserve.GraphBatchServer
        spec = QuerySpec if mod is None else je.QuerySpec
        server = cls(gg, ii, access="index", coldstore=cs)
        server.submit(spec.make("earliest_arrival", (0, width), sources=3))
        for k in range(10):
            server.tick(base + k * stride)
        assert cs.watermark > 0
        t_h = server.submit(spec.make("cc", hist_win, pinned=True))
        reps = [server.tick(base + (10 + j) * stride) for j in range(2)]
        servers.append((server, cs, t_h, reps))
    (server, cs, t_h, (rep, rep2)), (jserver, jcs, jt_h, (jrep, jrep2)) = servers
    assert cs.watermark == jcs.watermark
    assert GraphBatchServer.HISTORY_CLASS in rep.classes_served
    assert rep.classes_served == jrep.classes_served
    assert t_h in rep.results
    hstate = server._class_states[GraphBatchServer.HISTORY_CLASS]
    assert hstate.plan.tier in ("cold", "split")
    assert hstate.plan.cache_key == jserver._class_states["history"].plan.cache_key
    ref, _ = serve_batch(g, QueryBatch.make([QuerySpec.make("cc", hist_win)]), idx,
                         plan=hstate.plan)
    _assert_identical(rep.results[t_h], as_np(ref[0]), "daemon-hist")
    # next tick: the pinned window did NOT re-anchor: a noop repeat
    hstate2 = server._class_states[GraphBatchServer.HISTORY_CLASS]
    assert hstate2.last_advance == "noop"
    _assert_identical(rep2.results[t_h], as_np(ref[0]), "daemon-noop")
    for r, jr in ((rep, jrep), (rep2, jrep2)):
        assert set(r.results) == set(jr.results)
        for tid in r.results:
            _assert_matches_jax(jr.results[tid], r.results[tid], "", f"tenant {tid}")
    assert vars(server.stats) == vars(jserver.stats)


# ---------------------------------------------------------------------------
# 6. disk spill: memmap-backed sealed chunks
# ---------------------------------------------------------------------------

def test_spill_decode_and_stitch_parity(tmp_path):
    g, idx, t_min, t_max, jg, ji = _case()
    cs_mem = ColdStore(g, idx, chunk_slots=256)
    cs_dsk = ColdStore(g, idx, chunk_slots=256, spill_dir=str(tmp_path / "port"))
    jcs_dsk = JColdStore(jg, ji, chunk_slots=256, spill_dir=str(tmp_path / "jax"))
    for cs in (cs_mem, cs_dsk, jcs_dsk):
        cs.note_eviction(700)
        cs.note_eviction(2000)
    assert cs_dsk.n_chunks == cs_mem.n_chunks > 0
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == cs_dsk.n_chunks == cs_dsk.n_spilled
    assert files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in files:   # the same bytes on disk as the JAX package writes
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    assert cs_dsk.stats()["spilled_chunks"] == cs_dsk.n_chunks
    assert cs_dsk.stats() == jcs_dsk.stats()
    for cm, cd in zip(cs_mem.chunks, cs_dsk.chunks):
        assert isinstance(cd.src, np.memmap)
        assert (cd.pos_lo, cd.pos_hi, cd.t_lo, cd.t_hi) == (
            cm.pos_lo, cm.pos_hi, cm.t_lo, cm.t_hi)
        for a, b in zip(cm.decode(), cd.decode()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    span = t_max - t_min
    win = (t_min + span // 16, t_min + span // 16 + span // 20)
    lo, hi = window_positions_host(idx, win)
    cap = 1 << (max(hi - lo, 1) - 1).bit_length()
    fm, mm, lom, him = cs_mem.ring_stitch(win, cap)
    fd, md, lod, hid = cs_dsk.ring_stitch(win, cap)
    assert (lom, him) == (lod, hid)
    np.testing.assert_array_equal(mm, md)
    for a, b in zip(fm, fd):
        np.testing.assert_array_equal(a, b)


def test_spill_single_slot_chunks(tmp_path):
    """chunk_slots=1 seals zero-length delta columns: those stay in memory
    (mmap cannot map an empty span) and decode still round-trips."""
    g, idx, *_ = _case()
    cs = ColdStore(g, idx, chunk_slots=1, spill_dir=str(tmp_path))
    cs.note_eviction(4)
    assert cs.n_chunks == 4
    perm = as_np(idx.perm_by_start)
    for ch in cs.chunks:
        assert ch.dt_start.size == 0 and not isinstance(ch.dt_start, np.memmap)
        src, dst, ts, te, w = ch.decode()
        eid = perm[ch.pos_lo]
        assert int(src[0]) == int(as_np(g.src)[eid])
        assert int(ts[0]) == int(as_np(g.t_start)[eid])
        assert int(te[0]) == int(as_np(g.t_end)[eid])
    with pytest.raises(ValueError, match="chunk_slots"):
        ColdStore(g, idx, chunk_slots=0)
    with pytest.raises(ValueError, match="TGER"):
        ColdStore(g, None)


_FD_BOUND = """
import resource, sys
import numpy as np
sys.path.insert(0, {src!r})
from repro_torch.core import ColdStore, build_tger
from repro_torch.data.generators import power_law_temporal_graph
g = power_law_temporal_graph(200, 5000, seed=8, device="cpu")
idx = build_tger(g, degree_cutoff=48)
mem = ColdStore(g, idx, chunk_slots=8)
mem.note_eviction(g.n_edges)
resource.setrlimit(resource.RLIMIT_NOFILE, (64, resource.getrlimit(resource.RLIMIT_NOFILE)[1]))
dsk = ColdStore(g, idx, chunk_slots=8, spill_dir={spill!r})
dsk.note_eviction(g.n_edges)
assert dsk.n_spilled == dsk.n_chunks == 625
for ci in range(dsk.n_chunks):
    for a, b in zip(mem._decode(ci), dsk._decode(ci)):
        assert (np.asarray(a) == np.asarray(b)).all()
w = (int(g.t_start.min()), int(g.t_start.min()) + 20000)
for a, b in zip(mem.ring_stitch(w, 4096)[0], dsk.ring_stitch(w, 4096)[0]):
    assert (a == b).all()
print("ok")
"""


def test_spill_holds_no_open_file_per_chunk(tmp_path):
    """A spilled store of 625 chunks under a limit of 64 open files seals,
    decodes and stitches equal to the in-memory store: a spilled chunk is
    mapped only while read.  (The JAX package's store keeps every column
    of every spilled chunk mapped, an open file each, and runs out of file
    descriptors at a few thousand chunks: its fault, kept there.)"""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    code = _FD_BOUND.format(src=os.path.abspath(src), spill=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=False)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_spilled_time_travel_serving(tmp_path):
    """A cold-tier time-travel solve through a SPILLED store is
    bit-identical to the unspilled one, and equal to the JAX package's."""
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    width = max(span // 40, 1)
    hist = (t_min + span // 8, t_min + span // 8 + width)
    batch = QueryBatch.make([QuerySpec.make("earliest_arrival", hist, sources=3)])
    out = {}
    for tag, spill in (("mem", None), ("dsk", str(tmp_path))):
        cs = ColdStore(g, idx, chunk_slots=256, spill_dir=spill)
        cs.note_eviction(g.n_edges)
        res, st = serve_batch(g, batch, idx, coldstore=cs)
        assert st.plan.tier == "cold"
        out[tag] = as_np(res[0])
    np.testing.assert_array_equal(out["mem"], out["dsk"])
    jcs = JColdStore(jg, ji, chunk_slots=256)
    jcs.note_eviction(jg.n_edges)
    jres, _ = jserve.serve_batch(jg, je.QueryBatch.make(
        [je.QuerySpec.make("earliest_arrival", hist, sources=3)]), ji, coldstore=jcs)
    np.testing.assert_array_equal(out["mem"], np.asarray(jres[0]))


def test_sweep_incremental_time_travel():
    """``sweep_incremental(coldstore=)`` routes a below-horizon sweep to the
    cold tier as ``serve_batch`` does: the same rows as the JAX package,
    bit-identical to a cold sweep under the tier plan, and it refuses
    ``warm_start`` there."""
    g, idx, t_min, t_max, jg, ji = _case()
    span = t_max - t_min
    cs, jcs = ColdStore(g, idx, chunk_slots=256), JColdStore(jg, ji, chunk_slots=256)
    cs.note_eviction(g.n_edges // 2)
    jcs.note_eviction(jg.n_edges // 2)
    wins = np.asarray([(t_min + span // 10, t_min + span // 10 + span // 40),
                       (t_min + span // 8, t_min + span // 8 + span // 40)], np.int32)
    res, st = ws.sweep_incremental(g, 3, wins, idx, coldstore=cs)
    jres, jst = jserve.sweep_incremental(jg, 3, wins, ji, coldstore=jcs)
    assert st.plan.tier == jst.plan.tier == "cold"
    assert st.plan.cache_key == jst.plan.cache_key
    np.testing.assert_array_equal(as_np(res), np.asarray(jres))
    assert torch.equal(res, ws.sweep(g, 3, wins, idx, plan=st.plan))
    with pytest.raises(ValueError, match="warm_start"):
        ws.sweep_incremental(g, 3, wins, idx, coldstore=cs, warm_start=True)
