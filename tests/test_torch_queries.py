"""Query batches in the port against the JAX package's ``engine/queries.py``
and ``plan_batch``: spec normalization, row expansion, group order,
``dedup_rows``, ``bucket_capacity``, the batch signature and the batch
plan's cache key, equal value for value and character for character."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.engine as je
import repro.engine.plan as jplan
import repro_torch.engine as te
import repro_torch.engine.plan as tplan
import repro_torch.serve.window_sweep as tws
from test_torch_common import graph_pair, query_setup

ALGS = ("earliest_arrival", "bfs", "cc", "reachability", "kcore", "pagerank",
        "betweenness")


def _spec(Q, alg, window, src, params):
    return Q.QuerySpec.make(alg, window,
                            sources=None if alg in Q.SOURCE_FREE else src, **params)


def _rows(batch):
    return [(r.algorithm, r.params, r.source, r.window, r.spec_index)
            for r in batch.rows()]


def _same_batch(jb, tb):
    assert _rows(jb) == _rows(tb)
    assert [(k, [(r.source, r.window) for r in v]) for k, v in jb.groups().items()] == \
        [(k, [(r.source, r.window) for r in v]) for k, v in tb.groups().items()]
    assert jb.n_rows == tb.n_rows and jb.union() == tb.union()
    assert jb.windows() == tb.windows()
    assert jb.signature() == tb.signature()
    assert jb.signature(bucketed=True) == tb.signature(bucketed=True)
    assert {c: b.signature() for c, b in jb.by_cost_class().items()} == \
        {c: b.signature() for c, b in tb.by_cost_class().items()}


def test_constants_and_cost_classes():
    assert te.SOURCE_FREE == je.SOURCE_FREE
    assert te.DEEP_ALGORITHMS == je.DEEP_ALGORITHMS
    assert te.DEFAULT_COST_CLASS == je.DEFAULT_COST_CLASS
    for alg in ALGS:
        assert te.cost_class_for(alg) == je.cost_class_for(alg)
    assert set(tws.ALGORITHMS) == set(ALGS)
    for alg, entry in tws._ALGOS.items():
        assert entry.source_free == (alg in te.SOURCE_FREE), alg


def test_queryspec_expansion_and_groups():
    """test_multitenant.py's case, in both packages."""
    w0, w1 = (0, 10), (5, 20)

    def mk(Q):
        return Q.QueryBatch.make([
            Q.QuerySpec.make("earliest_arrival", w0, sources=[3, 5]),
            Q.QuerySpec.make("cc", w1),
            Q.QuerySpec.make("earliest_arrival", w1, sources=7),
            Q.QuerySpec.make("earliest_arrival", w0, sources=9, max_rounds=3),
        ])

    jb, tb = mk(je), mk(te)
    _same_batch(jb, tb)
    keys = list(tb.groups())
    assert len(keys) == 3 and keys[2][1] == (("max_rounds", 3),)
    assert [r.source for r in tb.groups()[keys[0]]] == [3, 5, 7]
    assert tb.union() == (0, 20) and tb.windows() == [w0, w1]


def test_queryspec_validation():
    for Q in (je, te):
        with pytest.raises(ValueError, match="source-free"):
            Q.QuerySpec.make("pagerank", (0, 5), sources=1)
        with pytest.raises(ValueError, match="source"):
            Q.QuerySpec.make("earliest_arrival", (0, 5))
        with pytest.raises(ValueError, match="at least one"):
            Q.QueryBatch.make([])
    spec = te.QuerySpec.make("bfs", np.array([0, 5]), sources=np.array([4, 5]),
                             cost_class="deep", pinned=True)
    assert vars(spec) == vars(je.QuerySpec.make(
        "bfs", np.array([0, 5]), sources=np.array([4, 5]), cost_class="deep",
        pinned=True))
    assert spec.resolved_cost_class == "deep" and spec.n_rows == 2


def test_batch_signature_keys_shape_not_values():
    def mk(Q, base, src):
        return Q.QueryBatch.make([
            Q.QuerySpec.make("earliest_arrival", (base, base + 10), sources=src),
            Q.QuerySpec.make("cc", (base + 2, base + 8)),
        ])

    assert mk(te, 0, 3).signature() == mk(te, 100, 7).signature() == mk(je, 0, 3).signature()
    other = te.QueryBatch.make([
        te.QuerySpec.make("earliest_arrival", (0, 10), sources=[3, 4]),
        te.QuerySpec.make("cc", (2, 8)),
    ])
    assert other.signature() != mk(te, 0, 3).signature()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 8, 9, 31, 33, 100])
@pytest.mark.parametrize("prev_cap", [0, 4, 8, 32, 64])
def test_bucket_capacity(n, prev_cap):
    assert te.bucket_capacity(n, prev_cap) == je.bucket_capacity(n, prev_cap)


def test_dedup_rows():
    sources = [1, 2, 1, None, 1, 2]
    windows = np.asarray([[0, 5], [0, 5], [0, 5], [0, 5], [1, 5], [0, 5]], np.int32)
    ju, jw, jinv = je.dedup_rows(sources, windows)
    tu, tw, tinv = te.dedup_rows(sources, windows)
    assert ju == tu == [1, 2, None, 1] and jinv == tinv == (0, 1, 0, 2, 3, 1)
    assert tw.dtype == jw.dtype and (tw == jw).all()


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_batch_normal_form_property(data):
    """Random batches: rows, groups, windows, cost classes, signatures and
    dedup maps equal in both packages."""
    n_specs = data.draw(st.integers(1, 7), label="n_specs")
    raw = []
    for i in range(n_specs):
        alg = data.draw(st.sampled_from(ALGS), label=f"alg{i}")
        a = data.draw(st.integers(0, 50), label=f"a{i}")
        w = (a, a + data.draw(st.integers(0, 20), label=f"w{i}"))
        src = data.draw(st.lists(st.integers(0, 9), min_size=1, max_size=3), label=f"s{i}")
        params = data.draw(st.sampled_from([{}, {"max_rounds": 3}, {"k": 2},
                                            {"n_iters": 5}]), label=f"p{i}")
        raw.append((alg, w, src, params))
    jb = je.QueryBatch.make([_spec(je, *r) for r in raw])
    tb = te.QueryBatch.make([_spec(te, *r) for r in raw])
    _same_batch(jb, tb)
    for (key, rows), (_, trows) in zip(jb.groups().items(), tb.groups().items()):
        srcs = [r.source for r in rows]
        wins = np.asarray([r.window for r in rows], np.int32)
        ju, jw, jinv = je.dedup_rows(srcs, wins)
        tu, tw, tinv = te.dedup_rows([r.source for r in trows], wins)
        assert (ju, jinv) == (tu, tinv) and (jw == tw).all()


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("access", ["auto", "scan", "index", "hybrid"])
@pytest.mark.parametrize("backend", ["xla_segment", "pallas_tiled"])
def test_plan_batch_identical(kind, access, backend):
    """The batch plan: the union plan of the batch's distinct windows with
    the signature on the cache key, in both packages."""
    jg, tg, ji, ti, wins, sources = query_setup(kind)

    def mk(Q):
        return Q.QueryBatch.make([
            Q.QuerySpec.make("earliest_arrival", wins[1], sources=sources),
            Q.QuerySpec.make("cc", wins[0]),
            Q.QuerySpec.make("pagerank", wins[1], n_iters=4),
            Q.QuerySpec.make("earliest_arrival", wins[0], sources=sources[0]),
        ])

    jb, tb = mk(je), mk(te)
    jp = jplan.plan_batch(jg, ji, jb, access=access, backend=backend)
    tp = tplan.plan_batch(tg, ti, tb, access=access, backend=backend)
    assert tp.batch_sig == jp.batch_sig == tb.signature()
    assert tp.cache_key == jp.cache_key
    assert tp.cache_key.endswith(f"/q{tb.signature()}")
    base = tplan.plan_query(tg, ti, windows=tb.windows(), access=access, backend=backend)
    assert (tp.method, tp.budget, tp.per_vertex_budget, tp.ring_capacity) == \
        (base.method, base.budget, base.per_vertex_budget, base.ring_capacity)


@pytest.mark.parametrize("kind", ["power_law", "transit"])
def test_decision_for_identical(kind):
    jg, tg, ji, ti, wins, _ = query_setup(kind)
    for w in wins:
        for force in (None, "index", "scan"):
            jd = jplan.decision_for(jg, ji, w, force=force)
            assert vars(jd) == vars(tplan.decision_for(tg, ti, w, force=force))
    jd, td = jplan.decision_for(jg, None, wins[0]), tplan.decision_for(tg, None, wins[0])
    assert vars(jd) == vars(td)


def test_plan_batch_options_not_in_the_port():
    """``plan_batch(shards=)`` (once outside the port, hence the name): the
    sharded signature suffix and the whole key equal the JAX package's on a
    mixed batch, bucketed or not; the sharded and the unsharded key
    differ only by the suffix."""
    jg, tg, ji, ti = graph_pair("transit")
    specs = lambda eng: [eng.QuerySpec.make("cc", (0, 10)),  # noqa: E731
                         eng.QuerySpec.make("earliest_arrival", (0, 10), sources=[1, 2]),
                         eng.QuerySpec.make("pagerank", (5, 10), n_iters=4)]
    tb, jb = te.QueryBatch.make(specs(te)), je.QueryBatch.make(specs(je))
    for bucketed in (False, True):
        base = tplan.plan_batch(tg, ti, tb, bucketed=bucketed).cache_key
        for shards in (1, 2, (1, 3), (2, 2)):
            key = tplan.plan_batch(tg, ti, tb, shards=shards, bucketed=bucketed).cache_key
            assert key == jplan.plan_batch(jg, ji, jb, shards=shards,
                                           bucketed=bucketed).cache_key
            assert key.startswith(base) and key[len(base):].startswith("@")
