"""The metric arithmetic: rates, tails, the trace reduction and the combine
byte counts."""
from types import SimpleNamespace

import pytest

from portbench import plugins, stats
from portbench import trace as tracing
from portbench.tests.conftest import REPO

Iv = tracing.Interval


def metric(name):
    return plugins.load_module(REPO, "metrics", name)


def test_rate_is_all_the_work_over_all_the_time():
    run = SimpleNamespace(unit="query", latencies_s=[0.1] * 30, window_s=4.0)
    assert metric("query_rate").read(run) == 7.5
    assert metric("advance_rate").read(run) is None
    run = SimpleNamespace(unit="advance", latencies_s=[0.1] * 30, window_s=4.0)
    assert metric("advance_rate").read(run) == 7.5
    assert metric("query_rate").read(run) is None


def test_p95_is_over_every_request():
    lat = [i / 1000 for i in range(1, 101)]      # 1..100 ms
    run = SimpleNamespace(unit="query", latencies_s=lat[::-1], window_s=5.0)
    assert metric("query_p95_ms").read(run) == pytest.approx(95.0)
    assert metric("advance_p95_ms").read(run) is None
    run = SimpleNamespace(unit="advance", latencies_s=lat, window_s=5.0)
    assert metric("advance_p95_ms").read(run) == pytest.approx(95.0)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 95) == 2.0


def test_idle_share_from_overlapping_kernels():
    device = [Iv("a", 1.0, 3.0), Iv("b", 2.0, 4.0),    # overlap: busy 1..4
              Iv("c", 6.0, 7.0), Iv("d", 9.0, 12.0)]   # clipped at 10
    host = [Iv("portbench.request", 0.0, 10.0), Iv("aten::item", 4.0, 6.0),
            Iv("cudaStreamSynchronize", 4.5, 5.9)]
    s = tracing.summarize(device, host, (0.0, 10.0))
    assert s.busy_s == pytest.approx(3.0 + 1.0 + 1.0)
    assert s.window_s == 10.0
    run = SimpleNamespace(trace=s)
    assert metric("device.idle_share.query").read(run) == pytest.approx(50.0)
    cpu = tracing.summarize([], host, (0.0, 10.0))          # no device interval
    assert metric("device.idle_share.query").read(SimpleNamespace(trace=cpu)) is None
    gaps = dict((k, v) for k, v in s.idle_gaps)
    assert gaps["portbench.request"] == pytest.approx(1.0 + 2.0)     # 0..1, 7..9
    assert gaps["aten::item > cudaStreamSynchronize"] == pytest.approx(2.0)   # 4..6
    ops = dict((k, v) for k, v in s.device_ops)
    assert ops == {"a": 2.0, "b": 2.0, "c": 1.0, "d": 1.0}      # d clipped to the window


def test_merged_and_gaps():
    busy = tracing.merged([Iv("x", 0, 2), Iv("y", 1, 3), Iv("z", 5, 6)], 0, 10)
    assert busy == [(0, 3), (5, 6)]
    assert tracing.gaps(busy, 0, 10) == [(3, 5), (6, 10)]


def test_combine_bytes_from_the_work_asked_for():
    """Two traced PageRank queries of 3 iterations over V = 10: the inside
    edges' source ids and the degrees once, then each iteration's float64
    contributions, destination ids and sums."""
    roof = metric("combine_roofline.query")
    counts = {"queries": 2, "iterations": 6, "window_edges": 100 + 50,
              "window_edge_iterations": 3 * 100 + 3 * 50, "vertices": 20}
    degree = 150 * 4 + 2 * 10 * 4
    rounds = 450 * (8 + 4) + 6 * 10 * 8
    assert roof.pagerank_bytes(counts) == degree + rounds
    assert roof.pagerank_bytes({"queries": 3, "rounds": 7}) == 0    # not a PageRank cell


def test_combine_kernels_by_name():
    kernel_s = {"void segment_min_tiles_kernel<256, 4, 2, true>(int const*)": 1.0,
                "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
                "_cuda_scatter_gather_internal_kernel<true, int>::ReduceMinimum>": 2.0,
                "void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>": 5.0,
                "void at::native::indexFuncLargeIndex<double, long>": 0.5}
    assert metric("combine_roofline.query").combine_seconds(kernel_s) == 3.5


def test_roofline_share_is_silent_without_a_card_or_counts():
    roof = metric("combine_roofline.query")
    counts = {"queries": 1, "iterations": 10, "window_edges": 10**9,
              "window_edge_iterations": 10**10, "vertices": 10**7}
    run = SimpleNamespace(trace=None, traced_counts=counts, device_kind="cpu")
    assert roof.read(run) is None
    kernel = "_scatter_gather_elementwise_kernel<128, 8, X<true, double>::ReduceAdd>"
    s = tracing.Summary(1.0, 0.5, [], [], {kernel: 0.1})
    run = SimpleNamespace(trace=s, traced_counts={"queries": 4, "rounds": 9},
                          device_kind="NVIDIA H100 80GB HBM3")
    assert roof.read(run) is None            # no count of the work: nothing to read
    run = SimpleNamespace(trace=s, traced_counts=counts, device_kind="NVIDIA H100 80GB HBM3")
    nbytes = 4e9 + 4e7 + 1.2e11 + 8e8
    assert roof.read(run) == pytest.approx(100 * nbytes / 3.35e12 / 0.1)
