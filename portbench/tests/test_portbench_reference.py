"""The plain reference against hand-worked cases."""
import numpy as np
import pytest
import torch

from portbench.reference import compare, temporal

INF = temporal.INF
# (src, dst, t_start, t_end)
EDGES = np.array([
    (0, 1, 1, 2),
    (1, 2, 2, 4),     # follows 0->1 (ends at 2, starts at 2: ties allowed)
    (2, 3, 3, 5),     # starts before the path reaches 2 (at 4): never taken
    (2, 3, 6, 7),
    (0, 3, 9, 20),    # ends after the window closes (15)
    (4, 5, 1, 1),     # another component
], dtype=np.int64).T


def _edges():
    return tuple(EDGES[i] for i in range(4))


def test_earliest_arrival_hand_worked():
    verts, arr = temporal.bellman_ford(*_edges(), [0, 4], (0, 15))
    got = dict(zip(verts.tolist(), arr[0].tolist()))
    assert got == {0: 0, 1: 2, 2: 4, 3: 7, 4: INF, 5: INF}
    assert dict(zip(verts.tolist(), arr[1].tolist()))[5] == 1


def test_strict_control_breaks_the_tie():
    verts, arr = temporal.bellman_ford(*_edges(), [0], (0, 15), strict=True)
    got = dict(zip(verts.tolist(), arr[0].tolist()))
    assert got[1] == 2 and got[2] == INF and got[3] == INF


def test_window_excludes_edges_that_leave_it():
    verts, arr = temporal.bellman_ford(*_edges(), [0], (2, 15))
    assert dict(zip(verts.tolist(), arr[0].tolist()))[1] == INF   # 0->1 starts at 1 < 2


def test_bfs_hops_count_the_first_round_reached():
    verts, arr, hops = temporal.bellman_ford(*_edges(), [0], (0, 15), hops=True)
    got = dict(zip(verts.tolist(), hops[0].tolist()))
    assert got == {0: 0, 1: 1, 2: 2, 3: 3, 4: INF, 5: INF}


def test_lower_time_precision_rounds_the_arrivals():
    s, d = np.array([0]), np.array([1])
    ts, te = np.array([2**24 + 1]), np.array([2**24 + 3])
    _, exact = temporal.bellman_ford(s, d, ts, te, [0], (0, 2**25))
    _, low = temporal.bellman_ford(s, d, ts, te, [0], (0, 2**25), time_dtype=torch.float32)
    assert int(exact[0, 1]) == 2**24 + 3 and int(low[0, 1]) != 2**24 + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lower_time_type_leaves_exact_times_and_unreached_vertices_as_they_are(dtype):
    """Times a float type holds exactly come back unchanged, and a vertex
    no path reaches reads INF, as in the integer reference: a control
    differs only where its precision drops bits."""
    verts, exact, hops = temporal.bellman_ford(*_edges(), [0, 4], (0, 15), hops=True)
    _, low, low_hops = temporal.bellman_ford(*_edges(), [0, 4], (0, 15), hops=True,
                                             time_dtype=dtype)
    assert low.dtype == torch.int64 and torch.equal(low, exact) and torch.equal(low_hops, hops)
    assert int((low == INF).sum()) == 2 + 4      # 4, 5 from 0; 0..3 from 4


def test_components_take_the_least_id():
    labels = temporal.connected_components(*_edges(), 7, (0, 15))
    assert labels.tolist() == [0, 0, 0, 0, 4, 4, 6]


def test_pagerank_hand_worked():
    # a 2-cycle and a sink: 0 <-> 1, 1 -> 2 in the window
    s, d = np.array([0, 1, 1]), np.array([1, 0, 2])
    ts = te = np.array([1, 1, 1])
    V, dmp = 3, 0.85
    pr = np.full(V, 1 / V)
    for _ in range(3):
        agg = np.zeros(V)
        agg[1] += pr[0]
        agg[0] += pr[1] / 2
        agg[2] += pr[1] / 2
        pr = (1 - dmp) / V + dmp * (agg + pr[2] / V)
    got = temporal.pagerank(s, d, ts, te, V, (0, 5), 3)
    assert np.allclose(got.numpy(), pr, rtol=1e-14, atol=0)
    nodangle = temporal.pagerank(s, d, ts, te, V, (0, 5), 1, dangling=False)
    want1 = (1 - dmp) / V + dmp * np.array([1 / 6, 1 / 3, 1 / 6])
    assert np.allclose(nodangle.numpy(), want1, rtol=1e-14, atol=0)


def test_pagerank_chunks_equal_one_pass():
    rng = np.random.default_rng(0)
    s, d = rng.integers(0, 50, 2000), rng.integers(0, 50, 2000)
    ts = rng.integers(0, 100, 2000)
    te = ts + rng.integers(0, 10, 2000)
    whole = temporal.pagerank(s, d, ts, te, 50, (10, 90), 5)
    parts = [tuple(torch.as_tensor(a[i:i + 300]) for a in (s, d, ts, te))
             for i in range(0, 2000, 300)]
    chunked = temporal.pagerank_chunks(lambda: parts, 50, (10, 90), 5)
    assert torch.allclose(whole, chunked, rtol=1e-12, atol=0)


def test_compare_counts_entries_off_the_sparse_answer():
    verts = torch.tensor([1, 3])
    want = torch.tensor([[5, INF]])
    got = torch.full((1, 5), INF, dtype=torch.int32)
    got[0, 1] = 5
    assert compare.sparse_mismatch(got, verts, want) == 0
    got[0, 4] = 9     # reached where the reference reaches nothing
    got[0, 1] = 6
    assert compare.sparse_mismatch(got, verts, want) == 2


@pytest.mark.parametrize("scale", [1.0, 1.001])
def test_max_rel_err(scale):
    want = torch.tensor([0.5, 0.25], dtype=torch.float64)
    assert compare.max_rel_err((want * scale).float(), want) == pytest.approx(
        abs(scale - 1), abs=1e-7)
