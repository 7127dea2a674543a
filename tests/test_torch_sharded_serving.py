"""Sharded batch serving in the port (``serve_batch(mesh=...)``,
``GraphBatchServer(mesh=...)``), mirroring ``test_sharded_serving.py`` for
results.

1. **Partition / dedup units**: ``row_partition`` (pad, never drop; the
   aligned and bucket-aligned forms) equal to the JAX package's, with the
   reference's hypothesis properties; ``serve_mesh`` shapes, the
   oversubscription check, ``dedup_rows``.
2. **In-process checks** on a gloo group of one rank: a D=1 query mesh
   drives the whole sharded path (row partition, per-rank solve, the
   all-gather) bit-identical to the unsharded engine and to JAX; a
   single-row batch; a mesh switch falls cold without consuming the state;
   ``sweep_incremental`` refuses a sharded state; ``GraphBatchServer``
   parity and stats.
3. **Soaks on spawned gloo ranks**, every advance held to the JAX
   unsharded engine (integer rows bit for bit, float rows within rtol
   1e-5): the reference's mixed 5-algorithm batch at D in {1, 2, 4} and at
   the 2-D (2, 2) mesh on index access, bucketed churn on (2, 2), the
   edge-shard boundary wrap-around cases at (2, 1) and (2, 2), and one
   scan / pallas_tiled chain at D=2 in which K1's and K3's plain versions
   run inside the sharded solves.  The reference's soaks run 64 / 48
   advances; these run 24 (the boundary cases 20 / 24 as there), which
   still crosses the ring's wrap twice.

What the reference asserts about traces (zero retraces, one SPMD program
per device) is not mirrored; the dispatch-log tags (``fused:index@q2``,
``fused:index@e2q2``) stand in for its one-dispatch check.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.core.temporal_graph as jtg_mod
import repro.distributed.query_shard as jqs
import repro.engine as je
import repro.serve.window_sweep as jws
import repro_torch.distributed.query_shard as tqs
import repro_torch.engine as te
import repro_torch.serve.window_sweep as ws
from repro_torch.engine.queries import bucket_capacity, dedup_rows
from repro_torch.serve import dispatch_log, serve_batch
from repro_torch.serve.engine import GraphBatchServer
from test_torch_common import jgen, jtger, one_rank_group, tgen, ttger
from test_torch_ranks import (
    BOUNDARY_CASES,
    CHURN_STEPS,
    SOAK_STEPS,
    TILED_STEPS,
    boundary_batch,
    boundary_case,
    mixed_batch,
    serve_case,
    serve_chain,
    serving_ranks,
    run_ranks,
)

TOL = dict(rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# 1. partition / dedup units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows,n_shards,cap,pad_map", [
    (8, 4, 2, list(range(8))),                  # even
    (1, 4, 1, [0, 0, 0, 0]),                    # one row, many shards
    (7, 4, 2, [0, 1, 2, 3, 4, 5, 6, 6]),        # prime rows
    (3, 4, 1, [0, 1, 2, 2]),                    # fewer rows than devices
])
def test_row_partition_units(n_rows, n_shards, cap, pad_map):
    for fn in (tqs.row_partition, jqs.row_partition):
        c, m = fn(n_rows, n_shards)
        assert c == cap and m.tolist() == pad_map and m.dtype == np.int32


@pytest.mark.parametrize("args,kw", [((0, 4), {}), ((4, 0), {}), ((4, 2), dict(align=0))])
def test_row_partition_rejects(args, kw):
    for fn in (tqs.row_partition, jqs.row_partition):
        with pytest.raises(ValueError):
            fn(*args, **kw)


@settings(max_examples=60, deadline=None)
@given(n_rows=st.integers(1, 97), n_shards=st.integers(1, 8), align=st.integers(1, 16))
def test_row_partition_property(n_rows, n_shards, align):
    """Pad, never drop; minimal (aligned) capacity; real row j at index j,
    pads alias only the last real row; equal to the JAX partition."""
    cap, pad_map = tqs.row_partition(n_rows, n_shards, align=align)
    jcap, jmap = jqs.row_partition(n_rows, n_shards, align=align)
    assert cap == jcap and (pad_map == jmap).all()
    cap0 = -(-n_rows // n_shards)
    assert cap % align == 0 and cap >= cap0 and cap - align < cap0
    assert pad_map.shape == (cap * n_shards,)
    assert pad_map[:n_rows].tolist() == list(range(n_rows))
    assert (pad_map[n_rows:] == n_rows - 1).all()


@settings(max_examples=60, deadline=None)
@given(n_rows=st.integers(1, 257), n_shards=st.integers(1, 8))
def test_row_partition_bucket_aligned(n_rows, n_shards):
    """The bucketed x mesh partition: chunk boundaries on bucket_capacity
    multiples; power-of-two rows over power-of-two shards snap exactly."""
    bucket = bucket_capacity(-(-n_rows // n_shards))
    cap, pad_map = tqs.row_partition(n_rows, n_shards, align=bucket)
    assert cap % bucket == 0 and cap * n_shards >= n_rows
    assert pad_map[:n_rows].tolist() == list(range(n_rows))
    if n_rows & (n_rows - 1) == 0 and n_shards & (n_shards - 1) == 0 \
            and n_shards <= n_rows:
        assert cap * n_shards == n_rows


@pytest.mark.parametrize("sources,windows,want", [
    ([3, 5, 3, None, 5, 3], [[0, 10], [0, 10], [0, 10], [0, 10], [2, 10], [0, 10]],
     ([3, 5, None, 5], [[0, 10], [0, 10], [0, 10], [2, 10]], (0, 1, 0, 2, 3, 0))),
    ([1, 2], [[0, 5], [0, 5]], ([1, 2], [[0, 5], [0, 5]], (0, 1))),
])
def test_dedup_rows(sources, windows, want):
    from repro.engine.queries import dedup_rows as jdedup

    wins = np.asarray(windows, np.int32)
    for fn in (dedup_rows, jdedup):
        u_src, u_win, inverse = fn(sources, wins)
        assert u_src == want[0] and u_win.tolist() == want[1] and inverse == want[2]


def test_meshes_need_a_process_group_of_their_size():
    """Without a process group every mesh raises ValueError; on a group of
    one rank, (1, D) is the 1-D query mesh, degenerate shapes raise, and a
    mesh larger than the group raises naming both sizes."""
    with pytest.raises(ValueError, match="no process group"):
        tqs.query_mesh(1)
    with one_rank_group():
        m = tqs.serve_mesh(1, 1)
        assert m.mesh_dim_names == (tqs.query_axis(),) == ("model",)
        assert tqs.query_mesh() is m and tqs.query_mesh(1) is m
        assert tqs.mesh_shape(m) == (1, 1) and tqs.mesh_shape(None) == (1, 1)
        m2 = tqs.make_mesh((1, 1), (tqs.edge_axis(), tqs.query_axis()))
        assert m2.mesh_dim_names == ("data", "model") and tqs.mesh_shape(m2) == (1, 1)
        for bad in ((0, 1), (1, 0)):
            with pytest.raises(ValueError):
                tqs.serve_mesh(*bad)
        with pytest.raises(ValueError, match="needs 4 ranks but the process group has 1"):
            tqs.serve_mesh(2, 2)
        with pytest.raises(ValueError, match="needs 2 ranks but the process group has 1"):
            tqs.query_mesh(2)
        with pytest.raises(ValueError, match="nccl"):
            tqs.query_mesh(1, device="cuda")
    assert (tqs.query_axis(), tqs.edge_axis()) == (jqs.query_axis(), jqs.edge_axis())


# ---------------------------------------------------------------------------
# 2. in-process checks on one rank
# ---------------------------------------------------------------------------

_CASE = {}


def _case():
    """(jax graph, jax index, port graph, port index, t_max, width, stride)
    of the reference soak; the in-process tests use the wider windows of
    the reference's in-process tests (span / 60, stride span / 240)."""
    if not _CASE:
        jg, ji, t_max, width, stride = serve_case(jgen, jtger.build_tger)
        tg, ti, *_ = serve_case(tgen, ttger.build_tger, device="cpu")
        _CASE["v"] = (jg, ji, tg, ti, t_max, width, stride)
    return _CASE["v"]


def _wide():
    jg, ji, tg, ti, t_max, width, stride = _case()
    ts = np.asarray(jg.t_start)
    span = t_max - int(ts.min())
    return max(span // 60, 1), max(span // 240, 1)


def _jax_chain(batches, **kw):
    jg, ji, *_ = _case()
    return serve_chain(jws.serve_batch, jws.dispatch_log, jg, ji, batches, **kw)


def _assert_rows(ref_rows, got_rows, what, exact_floats=False):
    for gi, (a, b) in enumerate(zip(ref_rows, got_rows)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape, (what, gi)
            if x.dtype.kind in "iub" or exact_floats:
                assert (x == y).all(), f"{what}: group {gi} differs"
            else:
                np.testing.assert_allclose(y, x, err_msg=f"{what}: group {gi}", **TOL)


@pytest.fixture(scope="module")
def group():
    with one_rank_group():
        yield


def test_sharded_d1_bit_identical_to_unsharded(group):
    """A D=1 query mesh drives the whole sharded path and matches the
    unsharded engine bit for bit (floats too: the same solve on the same
    rows) and JAX on every advance, including the uneven 18-row batch."""
    jg, ji, tg, ti, t_max, _, _ = _case()
    width, stride = _wide()
    base0 = t_max - 10 * stride
    mk = lambda eng, k: mixed_batch(eng, base0 + k * stride, width, stride)  # noqa: E731
    un = serve_chain(serve_batch, dispatch_log, tg, ti, [mk(te, k) for k in range(6)],
                     access="index")
    sh = serve_chain(serve_batch, dispatch_log, tg, ti, [mk(te, k) for k in range(6)],
                     access="index", mesh=1)
    ref = _jax_chain([mk(je, k) for k in range(6)], access="index")
    for k, (u, s, j) in enumerate(zip(un, sh, ref)):
        assert u[1] == s[1] == j[1]
        if u[1] == "delta":
            assert u[2] == ("fused:index",) and s[2] == ("fused:index@q1",)
        _assert_rows(u[0], s[0], f"D=1 step {k}", exact_floats=True)
        _assert_rows(j[0], s[0], f"JAX step {k}")


def test_sharded_single_row_batch(group):
    jg, ji, tg, ti, t_max, _, _ = _case()
    width, stride = _wide()
    base0 = t_max - 8 * stride

    def mk(eng, k):
        return eng.QueryBatch.make([eng.QuerySpec.make(
            "earliest_arrival", (int(base0 + k * stride - width), int(base0 + k * stride)),
            sources=7)])

    sh = serve_chain(serve_batch, dispatch_log, tg, ti, [mk(te, k) for k in range(4)],
                     access="index", mesh=1)
    ref = _jax_chain([mk(je, k) for k in range(4)], access="index")
    for (rows, *_), (jrows, *_) in zip(sh, ref):
        _assert_rows(jrows, rows, "single row")


def test_mesh_switch_falls_cold_without_consuming(group):
    """A state carried under one mesh is not consumed by a serve under
    another (or none): that serve falls cold; the sharded plan's key is
    mesh-bound, and the JAX package's key is the same."""
    jg, ji, tg, ti, t_max, _, _ = _case()
    width, _ = _wide()
    base = t_max - 4
    mk = lambda eng: eng.QueryBatch.make([eng.QuerySpec.make(  # noqa: E731
        "earliest_arrival", (base - width, base), sources=3)])
    _, state = serve_batch(tg, mk(te), ti, access="index", mesh=1)
    assert state.mesh is not None
    _, s2 = serve_batch(tg, mk(te), ti, state=state, access="index")
    assert s2.last_advance == "cold" and s2.mesh is None and not state.consumed
    _, s3 = serve_batch(tg, mk(te), ti, state=state, access="index", mesh=1)
    assert s3.last_advance == "noop"
    assert "@q1" in state.plan.cache_key and "@q1" not in s2.plan.cache_key
    _, jstate = jws.serve_batch(jg, mk(je), ji, access="index", mesh=1)
    assert jstate.plan.cache_key == state.plan.cache_key


def test_sweep_incremental_refuses_sharded_state(group):
    jg, ji, tg, ti, t_max, _, _ = _case()
    width, _ = _wide()
    base = t_max - 4
    batch = te.QueryBatch.make([te.QuerySpec.make(
        "earliest_arrival", (base - width, base), sources=3)])
    _, state = serve_batch(tg, batch, ti, access="index", mesh=1)
    res, s2 = ws.sweep_incremental(
        tg, 3, np.asarray([[base - width, base]], np.int32), ti, state=state)
    assert s2.mesh is None and s2.last_advance == "cold" and not state.consumed
    jres, _ = jws.sweep_incremental(
        jg, 3, np.asarray([[base - width, base]], np.int32), ji)
    assert (np.asarray(jres) == res.numpy()).all()


def test_graph_batch_server_parity_and_stats(group):
    """GraphBatchServer(mesh=1): rows equal the JAX unsharded chain, stats
    show 1 cold and 4 fused advances, and it reports its one device."""
    jg, ji, tg, ti, t_max, _, _ = _case()
    width, stride = _wide()
    base0 = t_max - 8 * stride
    steps = 5
    ref = _jax_chain([mixed_batch(je, base0 + k * stride, width, stride)
                      for k in range(steps)], access="index")
    server = GraphBatchServer(tg, ti, access="index", mesh=1)
    for k, (jrows, *_) in enumerate(ref):
        got = server.advance(mixed_batch(te, base0 + k * stride, width, stride))
        _assert_rows(jrows, [g if isinstance(g, tuple) else (g,) for g in got],
                     f"server step {k}")
    s = server.stats
    assert (s.advances, s.cold_advances, s.fused_dispatches) == (steps, 1, steps - 1)
    assert s.rows_served == steps * 18 and 0 < s.rows_solved <= s.rows_served
    assert server.devices == 1


def test_soak_d1_in_process(group, jax_soak):
    """The mixed soak at D=1 (the 1-D mesh of one gloo rank)."""
    _, _, tg, ti, t_max, width, stride = _case()
    base0 = t_max - (SOAK_STEPS + 2) * stride
    got = serve_chain(serve_batch, dispatch_log, tg, ti,
                      [mixed_batch(te, base0 + k * stride, width, stride)
                       for k in range(SOAK_STEPS)], access="index", mesh=1)
    _check_soak(jax_soak, got, "fused:index@q1")


# ---------------------------------------------------------------------------
# 3. soaks on spawned gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_soak():
    _, _, _, _, t_max, width, stride = _case()
    base0 = t_max - (SOAK_STEPS + 2) * stride
    return _jax_chain([mixed_batch(je, base0 + k * stride, width, stride)
                       for k in range(SOAK_STEPS)], access="index")


def _check_soak(ref, got, tag, exact_floats=False):
    wraps = 0
    for k, (r, g) in enumerate(zip(ref, got)):
        assert g[1] == r[1], f"step {k}: {g[1]} != {r[1]}"
        if k:
            assert g[1] == "delta" and g[2] == (tag,), (k, g[1], g[2])
            C = g[5]
            wraps += (got[k - 1][3] + C) // C != (g[3] + C - 1) // C
        _assert_rows(r[0], g[0], f"{tag} step {k}", exact_floats)
    assert wraps >= 1, "the soak never wrapped the ring"


@pytest.fixture(scope="module")
def ranks_2(tmp_path_factory):
    return run_ranks(serving_ranks, 2, tmp_path_factory.mktemp("serve2"),
                     (2, (2, 1)), ((2, 1),), None, 2)


@pytest.fixture(scope="module")
def ranks_4(tmp_path_factory):
    return run_ranks(serving_ranks, 4, tmp_path_factory.mktemp("serve4"),
                     (4, (2, 2)), ((2, 2),), (2, 2), None)


def _rank0(ranks, key):
    out, digest0 = ranks[0]
    for _, d in ranks[1:]:
        assert d[key] == digest0[key], f"rank rows differ from rank 0's at {key}"
    return out[key]


@pytest.mark.parametrize("world,mesh,tag", [
    (2, 2, "fused:index@q2"),
    (4, 4, "fused:index@q4"),
    (2, (2, 1), "fused:index@e2q1"),
    (4, (2, 2), "fused:index@e2q2"),
])
def test_soak_on_gloo_ranks_matches_jax(request, jax_soak, world, mesh, tag):
    ranks = request.getfixturevalue(f"ranks_{world}")
    _check_soak(jax_soak, _rank0(ranks, ("soak", mesh)), tag)


def test_bucketed_churn_on_2x2_mesh_matches_jax(ranks_4):
    """Bucketed admission on the (2, 2) mesh under tenant churn: every
    advance after the first is a delta, and each group's real rows equal
    the JAX unbucketed engine's."""
    _, _, _, _, t_max, width, stride = _case()
    base0 = t_max - (SOAK_STEPS + 2) * stride
    jbatches = [mixed_batch(je, base0 + k * stride, width, stride, n=12 + k % 3)
                for k in range(CHURN_STEPS)]
    ref = _jax_chain(jbatches, access="index")
    got = _rank0(ranks_4, ("bucketed", (2, 2)))
    for k, (r, g, b) in enumerate(zip(ref, got, jbatches)):
        if k:
            assert g[1] == "delta", (k, g[1])
        n_rows = [len(rows) for rows in b.groups().values()]
        _assert_rows(r[0], [tuple(x[:n] for x in grp) for grp, n in zip(g[0], n_rows)],
                     f"bucketed step {k}")


def test_tiled_scan_query_sharded_runs_k1_and_k3(ranks_2):
    """A scan / pallas_tiled chain at D=2: K1's and K3's plain versions run
    inside every sharded advance, and the rows equal JAX's."""
    _, _, _, _, t_max, width, stride = _case()
    base0 = t_max - (SOAK_STEPS + 2) * stride
    ref = _jax_chain([mixed_batch(je, base0 + k * stride, width, stride)
                      for k in range(TILED_STEPS)], access="scan")
    got = _rank0(ranks_2, ("tiled", 2))
    for k, (r, g) in enumerate(zip(ref, got)):
        _assert_rows(r[0], g[0], f"tiled step {k}")
        if k:
            assert g[1] == "reuse" and g[2] == ("fused:scan@q2",)
            assert g[3].get("segment_min_tiles", 0) > 0, g[3]
            assert g[3].get("segment_spmm_tiles", 0) > 0, g[3]


@pytest.mark.parametrize("world,mesh", [(2, (2, 1)), (4, (2, 2))])
def test_edge_sharded_mesh_refusals(request, world, mesh):
    """An edge-sharded mesh (E > 1) refuses scan access, a missing TGER
    and a non-index plan with ValueError, and the carried state survives."""
    refused, consumed = request.getfixturevalue(f"ranks_{world}")[0][0][("refusals", mesh)]
    assert len(refused) == 3 and not consumed
    assert "requires access='index'" in refused[0]
    assert "requires a TGER" in refused[1]
    assert "requires an index plan" in refused[2]


@pytest.fixture(scope="module")
def jax_boundary():
    g, idx = boundary_case(jtg_mod, jtger.build_tger)
    return {name: serve_chain(jws.serve_batch, jws.dispatch_log, g, idx,
                              [boundary_batch(je, k * s, w) for k in range(steps)],
                              access="index")
            for name, w, s, steps in BOUNDARY_CASES}


@pytest.mark.parametrize("world,mesh", [(2, (2, 1)), (4, (2, 2))])
@pytest.mark.parametrize("name", [c[0] for c in BOUNDARY_CASES])
def test_edge_shard_boundary_wraparound(request, jax_boundary, world, mesh, name):
    """An advance whose entering slots land exactly on a shard's base slot
    (exact-base) and one whose entering range straddles two shards
    (straddle), each bit-identical to the JAX unsharded engine on every
    advance across a full ring wrap."""
    got = _rank0(request.getfixturevalue(f"ranks_{world}"), ("boundary", name, mesh))
    ref = jax_boundary[name]
    saw_base = saw_straddle = False
    for k, (r, g) in enumerate(zip(ref, got)):
        assert g[1] == r[1] and (k == 0 or g[1] == "delta"), (k, g[1])
        _assert_rows(r[0], g[0], f"{name}@{mesh} step {k}", exact_floats=True)
        C = g[5]
        shard = C // mesh[0]
        if k and g[4] > got[k - 1][4]:
            slots = np.arange(got[k - 1][4], g[4]) % C
            saw_base |= int(slots[0]) % shard == 0
            saw_straddle |= len(set((slots // shard).tolist())) > 1
    assert saw_base if name == "exact-base" else saw_straddle
