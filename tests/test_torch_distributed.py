"""The port's distributed engine (``repro_torch.distributed.graph_engine``)
against the JAX package, mirroring ``test_distributed.py::
test_distributed_engine_8dev_subprocess`` for results.

1. Eight spawned gloo ranks on a ``(4, 2)`` ``("data", "model")`` mesh run
   the reference's graph (power_law, 90 vertices, 2,500 edges, seed 13, 4
   sources): the scan-path, index-budget (per-shard sorted) and top-K
   exchange EA equal JAX's ``earliest_arrival`` bit for bit; PageRank
   rounds match an unsharded JAX power iteration (allclose, the float sum
   crosses the ranks) and CC rounds match its rounds bit for bit; every
   rank holds the same result.
2. At world size 1 (a gloo group in this process) each round of
   ``make_ea_round_plan`` equals the JAX round function on a one-device
   ``("data", "model")`` mesh, round by round: the top-K exchange's tie
   order included; a ``("pod", "data", "model")`` mesh flattens its two
   edge dimensions into one.
3. The ``edges_time_sorted`` guard and the ``hybrid`` refusal raise as in
   JAX.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core  # noqa: F401  (the JAX package must import core before engine)
from repro.core.algorithms import earliest_arrival as j_earliest_arrival
from repro.distributed import graph_engine as jge
from repro.distributed.compat import make_mesh as j_make_mesh
from repro.engine.plan import make_plan as j_make_plan
from repro_torch.distributed import graph_engine as tge
from repro_torch.distributed import make_mesh as t_make_mesh
from repro_torch.engine.plan import make_plan as t_make_plan
from test_torch_common import as_np, jgen, one_rank_group
from test_torch_ranks import (
    ENGINE_GRAPH,
    ENGINE_ROUNDS,
    ENGINE_SOURCES,
    PR_ROUNDS,
    engine_case,
    engine_ranks,
    pagerank_inputs,
    run_ranks,
)

INT_INF = np.iinfo(np.int32).max
PR_TOL = dict(rtol=1e-5, atol=1e-7)


def _jax_case():
    g = jgen.power_law_temporal_graph(**ENGINE_GRAPH)
    ts = np.asarray(g.t_start)
    win = (int(np.quantile(ts, 0.4)), int(np.asarray(g.t_end).max()))
    return g, win


def _jax_ea(g, win):
    return np.stack([np.asarray(j_earliest_arrival(g, int(s), win))
                     for s in ENGINE_SOURCES])


def _jax_pagerank_rounds(g, win, damping=0.85):
    """The unsharded power iteration a PageRank round computes."""
    V = g.n_vertices
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    ts, te = np.asarray(g.t_start), np.asarray(g.t_end)
    inv = jnp.asarray(pagerank_inputs(src, ts, te, win, V))
    ok = jnp.asarray((ts >= win[0]) & (te <= win[1]))
    src_j, ids = jnp.asarray(src), jnp.where(ok, jnp.asarray(dst), 0)
    pr = jnp.full((V,), 1.0 / V, jnp.float32)
    out = []
    for _ in range(PR_ROUNDS):
        contrib = jnp.where(ok, pr[src_j] * inv[src_j], 0.0)
        agg = jax.ops.segment_sum(contrib, ids, num_segments=V)
        pr = (1.0 - damping) / V + damping * agg
        out.append(np.asarray(pr))
    return np.stack(out)


def _jax_cc_rounds(g, win):
    """The unsharded hash-min rounds (with the pointer jump) a CC round
    computes, until the labels stop changing."""
    V = g.n_vertices
    ts, te = np.asarray(g.t_start), np.asarray(g.t_end)
    ok = jnp.asarray((ts >= win[0]) & (te <= win[1]))
    src, dst = jnp.asarray(np.asarray(g.src)), jnp.asarray(np.asarray(g.dst))
    big = jnp.iinfo(jnp.int32).max
    labels = jnp.arange(V, dtype=jnp.int32)
    out = [np.asarray(labels)]
    for _ in range(ENGINE_ROUNDS):
        fwd = jax.ops.segment_min(jnp.where(ok, labels[src], big),
                                  jnp.where(ok, dst, 0), num_segments=V)
        bwd = jax.ops.segment_min(jnp.where(ok, labels[dst], big),
                                  jnp.where(ok, src, 0), num_segments=V)
        new = jnp.minimum(labels, jnp.minimum(fwd, bwd))
        new = jnp.minimum(new, new[new])
        out.append(np.asarray(new))
        if bool(jnp.all(new == labels)):
            break
        labels = new
    return np.stack(out)


@pytest.fixture(scope="module")
def engine_4x2(tmp_path_factory):
    """Every rank's results on the (4, 2) mesh, and JAX's."""
    ranks = run_ranks(engine_ranks, 8, tmp_path_factory.mktemp("engine"), (4, 2))
    g, win = _jax_case()
    return ranks, dict(ea=_jax_ea(g, win), pagerank=_jax_pagerank_rounds(g, win),
                       cc=_jax_cc_rounds(g, win))


@pytest.mark.parametrize("name", ["scan", "index", "topk8", "topk64", "index_topk8"])
def test_distributed_ea_8_ranks_equals_earliest_arrival(engine_4x2, name):
    ranks, ref = engine_4x2
    got, rounds = ranks[0][f"ea_{name}"]
    assert got.dtype == np.int32 and got.shape == ref["ea"].shape
    assert (got == ref["ea"]).all(), f"distributed {name} EA != earliest_arrival"
    assert 1 <= rounds < ENGINE_ROUNDS


def test_distributed_pagerank_rounds_match_jax(engine_4x2):
    ranks, ref = engine_4x2
    np.testing.assert_allclose(ranks[0]["pagerank"], ref["pagerank"], **PR_TOL)


def test_distributed_cc_rounds_match_jax(engine_4x2):
    ranks, ref = engine_4x2
    got = ranks[0]["cc"]
    assert got.shape == ref["cc"].shape        # the same number of rounds
    assert (got == ref["cc"]).all()


def test_every_rank_holds_the_same_result(engine_4x2):
    ranks, _ = engine_4x2
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for key, val in r.items():
            if key.startswith("ea_"):
                assert (val[0] == ranks[0][key][0]).all() and val[1] == ranks[0][key][1]
            else:
                assert (val == ranks[0][key]).all(), key


# ---------------------------------------------------------------------------
# 2. world size 1: round by round against the JAX round function
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    with one_rank_group():
        yield


def _round_cases():
    return {
        "scan": (dict(), False),
        "index": (dict(method="index", budget=1024), True),
        "topk": (dict(exchange_budget=8), False),
        "index_topk": (dict(method="index", budget=1024, exchange_budget=16), True),
    }


@pytest.mark.parametrize("case", list(_round_cases()))
def test_rounds_equal_jax_round_by_round_at_world_size_1(group, case):
    kw, sort = _round_cases()[case]
    jg, win = _jax_case()
    tg, twin = engine_case()
    assert win == twin
    V, S = jg.n_vertices, len(ENGINE_SOURCES)
    jmesh = j_make_mesh((1, 1), ("data", "model"))
    tmesh = t_make_mesh((1, 1), ("data", "model"))
    method = kw.pop("method", "scan")
    jround = jax.jit(jge.make_ea_round_plan(jmesh, V, j_make_plan(method, **kw)))
    tround = tge.make_ea_round_plan(tmesh, V, t_make_plan(method, **kw))
    if sort:
        jedges = jge.sort_edges_by_time_per_shard(jmesh, jg.src, jg.dst, jg.t_start,
                                                  jg.t_end)
        tedges = tge.sort_edges_by_time_per_shard(tmesh, tg.src, tg.dst, tg.t_start,
                                                  tg.t_end)
    else:
        jedges = (*jge.shard_edges(jmesh, jg.src, jg.dst, jg.t_start, jg.t_end),
                  jge.shard_edges(jmesh, jnp.ones(jg.n_edges, bool))[0])
        tedges = (*tge.shard_edges(tmesh, tg.src, tg.dst, tg.t_start, tg.t_end),
                  tge.shard_edges(tmesh, torch.ones(tg.n_edges, dtype=torch.bool))[0])
    for a, b in zip(jedges, tedges):
        assert (np.asarray(a) == as_np(b)).all()
    arr = np.full((S, V), INT_INF, np.int32)
    arr[np.arange(S), list(ENGINE_SOURCES)] = win[0]
    jarr, tarr = jnp.asarray(arr), torch.from_numpy(arr)
    jwin = jnp.asarray(win, jnp.int32)
    for rnd in range(ENGINE_ROUNDS):
        jnew = jround(jarr, *jedges, jwin)
        tnew = tround(tarr, *tedges, win)
        assert (np.asarray(jnew) == as_np(tnew)).all(), f"round {rnd} differs"
        if bool(jnp.all(jnew == jarr)):
            break
        jarr, tarr = jnew, tnew
    else:
        pytest.fail("no fixpoint within the round limit")
    assert rnd >= 2


# ---------------------------------------------------------------------------
# 3. guards
# ---------------------------------------------------------------------------

def test_unsorted_budget_plan_and_hybrid_raise_as_in_jax(group):
    jg, win = _jax_case()
    tg, _ = engine_case()
    jmesh = j_make_mesh((1, 1), ("data", "model"))
    tmesh = t_make_mesh((1, 1), ("data", "model"))
    V = jg.n_vertices
    for fn, mesh, mk in ((jge, jmesh, j_make_plan), (tge, tmesh, t_make_plan)):
        with pytest.raises(ValueError, match="hybrid"):
            fn.make_ea_round_plan(mesh, V, mk("hybrid", per_vertex_budget=16))
    arr = np.full((1, V), INT_INF, np.int32)
    jedges = jge.shard_edges(jmesh, jg.src, jg.dst, jg.t_start, jg.t_end)
    tedges = tge.shard_edges(tmesh, tg.src, tg.dst, tg.t_start, tg.t_end)
    with pytest.raises(ValueError, match="sorted"):
        jge.run_distributed_ea(jmesh, jnp.asarray(arr), jedges, None, win,
                               plan=j_make_plan("index", budget=64))
    with pytest.raises(ValueError, match="sorted"):
        tge.run_distributed_ea(tmesh, torch.from_numpy(arr), tedges, None, win,
                               plan=t_make_plan("index", budget=64))


def test_pod_and_data_edge_dimensions_flatten_into_one(group):
    """A ("pod", "data", "model") mesh: edges shard over both edge
    dimensions (flattened into one group), sources over "model"; the scan
    and top-K EA equal JAX's ``earliest_arrival``."""
    jg, win = _jax_case()
    tg, _ = engine_case()
    mesh = t_make_mesh((1, 1, 1), ("pod", "data", "model"))
    assert tge.edge_mesh_axis(mesh).size == 1 and tge.source_mesh_axis(mesh).size == 1
    V, S = tg.n_vertices, len(ENGINE_SOURCES)
    arr0 = torch.full((S, V), INT_INF, dtype=torch.int32)
    arr0[torch.arange(S), torch.tensor(ENGINE_SOURCES)] = win[0]
    edges = tge.shard_edges(mesh, tg.src, tg.dst, tg.t_start, tg.t_end)
    evalid = tge.shard_edges(mesh, torch.ones(tg.n_edges, dtype=torch.bool))[0]
    ref = _jax_ea(jg, win)
    for plan in (None, t_make_plan("scan", exchange_budget=8)):
        out = tge.run_distributed_ea(mesh, arr0, edges, evalid, win, plan=plan)
        assert (as_np(out) == ref).all()


@pytest.mark.parametrize("chunk", [97, 4096])
def test_engine_in_small_chunks_matches_one_pass(group, monkeypatch, chunk):
    """Every round reduced ``chunk`` candidates a pass (and the top-K
    exchange sorting a row at a time, where a row has more entries than the
    chunk) gives the one-pass results: EA in all five plans (and their
    round counts) and CC bit for bit, PageRank within PR_TOL; the plans
    that see every window edge at world size 1 equal JAX's EA, and CC
    JAX's rounds.  (At world size 1 the index budget of 1024 does not hold
    the whole window, so the index plans are held to the one-pass run.)"""
    jg, win = _jax_case()
    one_pass = engine_ranks(0, (1, 1))
    monkeypatch.setattr(tge, "EDGE_CHUNK", chunk)
    got = engine_ranks(0, (1, 1))
    ref = _jax_ea(jg, win)
    for name in ("scan", "index", "topk8", "topk64", "index_topk8"):
        assert (got[f"ea_{name}"][0] == one_pass[f"ea_{name}"][0]).all(), name
        assert got[f"ea_{name}"][1] == one_pass[f"ea_{name}"][1], name
        if "index" not in name:
            assert (got[f"ea_{name}"][0] == ref).all(), name
    np.testing.assert_allclose(got["pagerank"], one_pass["pagerank"], **PR_TOL)
    np.testing.assert_allclose(got["pagerank"], _jax_pagerank_rounds(jg, win), **PR_TOL)
    assert (got["cc"] == one_pass["cc"]).all()
    assert (got["cc"] == _jax_cc_rounds(jg, win)).all()
