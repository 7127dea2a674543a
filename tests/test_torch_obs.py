"""The port's spans and counters (``repro_torch.obs``) on the CPU.

Off (no profiler session): nothing is kept and ``record_function`` is never
entered.  On (a CPU ``torch.profiler`` session): a tiny ``serve_batch`` chain
(scan access, ``pallas_tiled`` backend: the plain versions here) and a
``run_distributed_ea`` on a one-rank gloo group record the span tree of
``obs``' docstring, one request id per root, starts within 1 ms of the
profiler's own events of the same names, one ``fixpoint.round`` a round, and
the counters pinned below.  The dispatch tags are the same on and off."""
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.core.tger as ttger
import repro_torch.data.generators as tgen
from repro_torch import obs
from repro_torch.distributed import graph_engine as ge
from repro_torch.distributed import init_process_group, make_mesh
from repro_torch.engine import QueryBatch, QuerySpec
from repro_torch.engine.plan import make_plan
from repro_torch.serve import dispatch_log, serve_batch, sliding_windows

TENANTS = (("earliest_arrival", {}), ("bfs", {}), ("cc", {}), ("pagerank", {"n_iters": 5}))
SOURCES = (3, 17)
ADVANCES = 3            # the cold serve, then two steady advances
# the counters of the chain and of the EA query, pinned from one run
CHAIN_ROUNDS = 45
CHAIN_HOST_READS = 39
EA_ROUNDS = 5


def _graph():
    g = tgen.power_law_temporal_graph(200, 5000, seed=8, device="cpu")
    return g, ttger.build_tger(g, degree_cutoff=48)


def _batch(g, k):
    ts, te = g.t_start.numpy(), g.t_end.numpy()
    width = (int(te.max()) - int(ts.min())) // 4
    base = int(ts.min()) + 2 * width + k * (width // 8)
    specs = []
    for w in sliding_windows(base, width, width // 8, 2):
        w = (int(w[0]), int(w[1]))
        for alg, params in TENANTS:
            src = None if alg in ("cc", "pagerank") else list(SOURCES)
            specs.append(QuerySpec.make(alg, w, sources=src, **params))
    return QueryBatch.make(specs)


def _chain(g, tger):
    """The chain's dispatch tags per advance and its results."""
    state, tags, out = None, [], []
    for k in range(ADVANCES):
        with dispatch_log() as log:
            res, state = serve_batch(g, _batch(g, k), tger, state=state, access="scan",
                                     backend="pallas_tiled")
        tags.append(list(log))
        out.append(res)
    return tags, out


def _profiled(fn):
    obs.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        result = fn()
    return result, obs.records(), prof


def _profiler_starts(prof, names):
    """Start stamps (ns) of the profiler's own CPU events, by name."""
    from torch.autograd import DeviceType

    out = {n: [] for n in names}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.name() in out:
            out[ev.name()].append(ev.start_ns())
    return {n: sorted(v) for n, v in out.items()}


def _assert_on_profiler_clock(spans, prof):
    names = {s.name for s in spans}
    theirs = _profiler_starts(prof, names)
    for name in names:
        ours = sorted(s.start_ns for s in spans if s.name == name)
        assert len(ours) == len(theirs[name]), name
        assert max(abs(a - b) for a, b in zip(ours, theirs[name])) < 1_000_000, name


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def _root_of(spans, s):
    while s.parent >= 0:
        s = spans[s.parent]
    return s


def test_off_keeps_nothing_and_enters_no_record_function(monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __init__(self, *a, **k):
            entered.append(a)
            super().__init__(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    obs.reset()
    g, tger = _graph()
    _chain(g, tger)
    with obs.span("x", stage=True):
        obs.count("host_reads")
    assert obs.records() == obs.Records([], {})
    assert entered == []


def test_dispatch_tags_are_the_same_on_and_off():
    g, tger = _graph()
    off, res_off = _chain(g, tger)
    (on, res_on), _, _ = _profiled(lambda: _chain(g, tger))
    assert off == on
    assert off[0] == ["cold:view"] + ["cold:solve"] * len(TENANTS)
    assert off[1:] == [["fused:scan"]] * (ADVANCES - 1)
    for a, b in zip(res_off, res_on):
        for x, y in zip(a, b):
            for xi, yi in zip(x if isinstance(x, tuple) else (x,),
                              y if isinstance(y, tuple) else (y,)):
                assert torch.equal(xi, yi)


def test_serving_chain_records_the_span_tree():
    g, tger = _graph()
    _, rec, prof = _profiled(lambda: _chain(g, tger))
    spans = rec.spans
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == ["serve.advance"] * ADVANCES
    assert len({s.request for s in roots}) == ADVANCES
    for s in spans:
        assert s.request == _root_of(spans, s).request
        stage = s.name not in ("serve.match", "serve.schedule", "serve.assemble")
        assert s.stage == stage and (s.device_ms is not None) == stage
        assert s.device_ms is None or s.device_ms >= 0
        assert s.start_ns <= s.end_ns
    solves = [f"serve.solve.{alg}" for alg, _ in TENANTS]
    # the cold serve's rows are all distinct: no fan-out to assemble
    assert [s.name for s in _children(spans, roots[0])] == ["serve.view"] + solves
    assert roots[0].notes == ["cold:solve"] * len(TENANTS)
    for root in roots[1:]:
        names = [s.name for s in _children(spans, root)]
        assert names == (["serve.match", "serve.schedule"]
                         + [n for alg in solves for n in (alg, "serve.assemble")])
        assert root.notes == ["fused:scan"]
    assert all(not _children(spans, s) for s in spans if s.parent >= 0)
    assert spans[roots[0].index + 1].notes == ["cold:view"]
    _assert_on_profiler_clock(spans, prof)
    # every counter is taken under a root: the roots' counts sum to the totals
    for name in ("fixpoint.rounds", "host_reads"):
        assert sum(r.counts.get(name, 0) for r in roots) == rec.counts[name]
    # PageRank's iterations read nothing; the other three loops read their
    # condition once a round and once more to stop
    n_iters = dict(TENANTS)["pagerank"]["n_iters"]
    for r in roots:
        assert r.counts["host_reads"] == r.counts["fixpoint.rounds"] - n_iters + 3
    assert rec.counts == {"fixpoint.rounds": CHAIN_ROUNDS, "host_reads": CHAIN_HOST_READS}


@pytest.fixture
def one_rank():
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group("cpu", init_method="file://" + os.path.join(tmp, "store"),
                           world_size=1, rank=0)
        try:
            yield make_mesh((1, 1), ("data", "model"))
        finally:
            dist.destroy_process_group()


def test_distributed_ea_records_one_round_span_a_round(one_rank):
    g, _ = _graph()
    mesh = one_rank
    edges = ge.sort_edges_by_time_per_shard(mesh, g.src, g.dst, g.t_start, g.t_end)
    ts = g.t_start.numpy()
    window = (int(np.quantile(ts, 0.3)), int(g.t_end.max()))
    sources = torch.tensor([3, 17, 40, 41])
    arrival0 = torch.full((4, g.n_vertices), ge.INT_INF, dtype=torch.int32)
    arrival0[torch.arange(4), sources] = window[0]

    def query():
        return ge.run_distributed_ea(mesh, arrival0, edges[:4], edges[4], window,
                                     plan=make_plan("index", budget=4096),
                                     edges_time_sorted=True, with_rounds=True)

    plain, plain_rounds = query()
    (out, rounds), rec, prof = _profiled(query)
    assert torch.equal(out, plain) and rounds == plain_rounds == EA_ROUNDS
    spans = rec.spans
    (root,) = [s for s in spans if s.parent < 0]
    assert root.name == "ea.query" and not root.stage and root.device_ms is None
    kids = _children(spans, root)
    assert [s.name for s in kids] == ["fixpoint.round"] * rounds + ["ea.gather"]
    for r in kids[:-1]:
        assert r.stage and r.device_ms is not None
        inner = _children(spans, r)
        assert [s.name for s in inner] == ["fixpoint.relax", "fixpoint.converge"]
        assert not inner[0].stage and inner[1].stage
        assert inner[1].device_ms <= r.device_ms
    assert all(s.request == root.request for s in spans)
    _assert_on_profiler_clock(spans, prof)
    assert rec.counts == {"fixpoint.rounds": rounds, "host_reads": 2 * rounds}
    assert root.counts == rec.counts
