"""The per-layer metrics that read the port's spans and counters
(``repro_torch.obs``): each reader on synthetic records, nothing without
records, and a traced run of each tiny cell on the CPU reporting them where
their ``workloads`` say."""
from types import SimpleNamespace

import pytest

from portbench import bench, plugins
from portbench.tests.conftest import CELLS, REPO, SEED
from repro_torch import obs

SERVE = ("serve.solve_device_ms_per_advance", "serve.rounds_per_advance",
         "serve.host_reads_per_advance")
EA = ("fixpoint.round_device_ms", "fixpoint.converge_device_ms")


def metric(name):
    return plugins.load_module(REPO, "metrics", name)


def _records(*roots):
    """Records of ``roots``: each ``(name, counts, [(child, device_ms,
    [(grandchild, device_ms), ...]), ...])``, one request each."""
    spans = []

    def add(name, parent, request, ms, counts=None):
        s = obs.Span(name, len(spans), parent, request, ms is not None, device_ms=ms,
                     counts=dict(counts or {}))
        spans.append(s)
        return s

    for request, (name, counts, children) in enumerate(roots):
        root = add(name, -1, request, None, counts)
        for child, ms, grand in children:
            c = add(child, root.index, request, ms)
            for g, gms in grand:
                add(g, c.index, request, gms)
    return obs.Records(spans, {})


def _advance(solve_ms, rounds, reads):
    return ("serve.advance", {"fixpoint.rounds": rounds, "host_reads": reads},
            [("serve.match", 0.5, [])]
            + [(f"serve.solve.{a}", ms, []) for a, ms in zip(("cc", "pagerank"), solve_ms)]
            + [("serve.assemble", 0.25, [])])


def _query(rounds):
    return ("ea.query", {}, [("fixpoint.round", ms, [("fixpoint.relax", None),
                                                     ("fixpoint.converge", ms / 4)])
                             for ms in rounds] + [("ea.gather", None, [])])


def test_serve_readers_take_the_last_advances(monkeypatch):
    # an earlier session's advance, then the traced window's two
    rec = _records(_advance((100.0, 100.0), 99, 99), _advance((3.0, 5.0), 30, 20),
                   _advance((4.0, 6.0), 32, 22))
    monkeypatch.setattr(obs, "records", lambda: rec)
    run = SimpleNamespace(traced_counts={"advances": 2})
    assert metric("serve.solve_device_ms_per_advance").read(run) == pytest.approx(9.0)
    assert metric("serve.rounds_per_advance").read(run) == 31.0
    assert metric("serve.host_reads_per_advance").read(run) == 21.0
    for name in SERVE:       # more advances than roots: not this run's records
        assert metric(name).read(SimpleNamespace(traced_counts={"advances": 4})) is None


def test_fixpoint_readers_average_the_last_queries_rounds(monkeypatch):
    rec = _records(_query([100.0]), _query([40.0, 44.0]), _query([42.0, 38.0, 36.0]))
    monkeypatch.setattr(obs, "records", lambda: rec)
    run = SimpleNamespace(traced_counts={"queries": 2})
    assert metric("fixpoint.round_device_ms").read(run) == pytest.approx(40.0)
    assert metric("fixpoint.converge_device_ms").read(run) == pytest.approx(10.0)
    for name in EA:
        assert metric(name).read(SimpleNamespace(traced_counts={"queries": 4})) is None


@pytest.mark.parametrize("name", SERVE + EA)
def test_readers_give_nothing_without_records(monkeypatch, name):
    monkeypatch.setattr(obs, "records", lambda: obs.Records([], {}))
    counts = {"advances": 3, "queries": 3}
    assert metric(name).read(SimpleNamespace(traced_counts=counts)) is None
    assert metric(name).read(SimpleNamespace(traced_counts={})) is None


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics(tiny_root, cell):
    """On the CPU a stage span's extent is its host duration, so every
    cell that lists a span metric reports it; the others report none."""
    res = bench.run_cell(tiny_root, cell, SEED, 0.8, True, device="cpu")
    assert res["correct"]
    spec = plugins.load_cell(tiny_root, cell)
    listed = {m["name"] for m in spec.per_layer} & set(SERVE + EA)
    assert listed == {"kairos1e7.serve": set(SERVE), "kairos1e9.ea_selective": set(EA),
                      "kairos1e9.pagerank": set()}[cell]
    for name in listed:
        assert res["metrics"][name]["value"] > 0, name
    assert not set(SERVE + EA) - listed & set(res["metrics"])
