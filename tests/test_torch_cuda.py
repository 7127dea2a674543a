"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  Integer
kernels (K1, K2) are held to bit-identity; the float sum kernel (K3) adds
with atomics in no fixed order and is held within rtol/atol 2e-4, the JAX
kernel sweep's tolerance.  The file
imports no JAX (the machine with the card has none); the plain versions it
compares against are held to the JAX kernels by ``test_torch_kernels.py``.
Run on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_tger, plan_query
from repro_torch.core.algorithms import (
    earliest_arrival,
    temporal_bfs,
    temporal_cc,
    temporal_pagerank,
)
from repro_torch.data.generators import power_law_temporal_graph, transit_temporal_graph
from repro_torch.engine.backends import segments_for
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.kernels import segment_spmm as spmm
from repro_torch.kernels import temporal_edgemap as tem

pytestmark = pytest.mark.cuda

SHAPES = [  # n_v, n_e, tile_v, block_e (as the JAX kernel sweep)
    (100, 700, 64, 128),
    (700, 6000, 256, 512),
    (513, 2000, 128, 256),
    (64, 64, 64, 128),
    (50, 0, 64, 128),          # empty graph: one all-padding block
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _layout_inputs(n_v, n_e, tile_v, block_e, seed):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_v, n_e)
    lay = ops.prepare_layout(dst, n_v, tile_v=tile_v, block_e=block_e)
    perm = lay.perm.numpy()
    seg = np.append(dst, 0)[np.where(perm >= 0, perm, n_e)]  # padding -> 0
    dst_local = torch.as_tensor((seg % tile_v).astype(np.int32))
    return lay, lay.perm >= 0, dst_local, rng


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e", SHAPES)
@pytest.mark.parametrize("n_windows", [0, 3])
def test_segment_min_tiles_kernel_matches_plain(cuda, n_v, n_e, tile_v, block_e,
                                                n_windows):
    lay, lane, dst_local, rng = _layout_inputs(n_v, n_e, tile_v, block_e, n_e)
    shape = (n_windows, lay.n_edges_padded) if n_windows else (lay.n_edges_padded,)
    cand = rng.integers(0, 1000, shape).astype(np.int32)
    cand[..., rng.random(lay.n_edges_padded) < 0.3] = tem.INT_INF
    cand = torch.where(lane, torch.as_tensor(cand), tem.INT_INF)
    want = tem.segment_min_tiles_plain(dst_local, cand, lay.block_tile,
                                       lay.n_tiles, tile_v=tile_v, block_e=block_e)
    before = tem.segment_min_tiles.launches
    got = tem.segment_min_tiles(dst_local.to(cuda), cand.to(cuda),
                                lay.block_tile.to(cuda), lay.n_tiles,
                                tile_v=tile_v, block_e=block_e)
    torch.cuda.synchronize()
    assert tem.segment_min_tiles.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e", SHAPES)
@pytest.mark.parametrize("strict", [False, True])
def test_relax_min_tiles_kernel_matches_plain(cuda, n_v, n_e, tile_v, block_e,
                                              strict):
    lay, lane, dst_local, rng = _layout_inputs(n_v, n_e, tile_v, block_e, n_e + 1)
    ep = lay.n_edges_padded

    def field(lo, hi):
        return torch.as_tensor(rng.integers(lo, hi, ep).astype(np.int32))

    arr = torch.where(torch.as_tensor(rng.random(ep) < 0.2), tem.INT_INF, field(0, 500))
    ts = field(0, 1000)
    te = ts + field(0, 100)
    valid = lane.to(torch.int32)
    window = (100, 900)
    want = tem.temporal_relax_min_tiles_plain(
        dst_local, arr, ts, te, valid, lay.block_tile, window, lay.n_tiles,
        tile_v=tile_v, block_e=block_e, strict=strict)
    got = tem.temporal_relax_min_tiles(
        *(t.to(cuda) for t in (dst_local, arr, ts, te, valid, lay.block_tile)),
        window, lay.n_tiles, tile_v=tile_v, block_e=block_e, strict=strict)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_wrappers_reject_bad_input(cuda):
    lay, lane, dst_local, _ = _layout_inputs(100, 700, 64, 128, 0)
    cand = torch.zeros(lay.n_edges_padded, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        tem.segment_min_tiles(dst_local.to(cuda), cand, lay.block_tile.to(cuda),
                              lay.n_tiles, tile_v=64, block_e=128)
    with pytest.raises(ValueError):  # mixed devices
        tem.segment_min_tiles(dst_local, cand.int(), lay.block_tile.to(cuda),
                              lay.n_tiles, tile_v=64, block_e=128)


def test_earliest_arrival_on_card_matches_cpu(cuda):
    """The main path on the card equals the CPU run, and went through the
    kernels."""
    kw = dict(n_vertices=2000, n_edges=30000, seed=5)
    results = []
    for dev in ("cpu", cuda):
        g = power_law_temporal_graph(**kw, device=dev)
        idx = build_tger(g, degree_cutoff=256)
        t_hi = int(g.t_end.max())
        win = (int(g.t_start.min()), t_hi)
        plan = plan_query(g, idx, win, access="scan", backend="pallas_tiled")
        reset_launch_counts()
        a = earliest_arrival(g, 0, win, idx, plan=plan)
        b = ops.earliest_arrival_kernel(
            g, ops.prepare_layout(g.dst, g.n_vertices), 0, win)
        results.append((a.cpu(), b.cpu(), launch_counts()))
        if dev != "cpu":
            assert segments_for(plan, g.dst, use_layout=True).tiles is not None
    (a0, b0, n0), (a1, b1, n1) = results
    assert torch.equal(a0, a1) and torch.equal(b0, b1) and torch.equal(a0, b0)
    assert set(n0.values()) == {0}
    assert n1["segment_min_tiles"] > 0 and n1["temporal_relax_min_tiles"] > 0


# -- K3: segment_spmm_tiles (float atomics: held within rtol/atol 2e-4) -------

@pytest.mark.parametrize("n_v,n_e,tile_v,block_e", SHAPES)
@pytest.mark.parametrize("d", [1, 16, 130])
@pytest.mark.parametrize("n_windows", [0, 1, 3])
def test_segment_spmm_tiles_kernel_matches_plain(cuda, n_v, n_e, tile_v, block_e, d,
                                                 n_windows):
    lay, lane, dst_local, rng = _layout_inputs(n_v, n_e, tile_v, block_e, n_e + d)
    lead = (n_windows,) if n_windows else ()
    ep = lay.n_edges_padded
    msgs = torch.as_tensor(rng.standard_normal(lead + (ep, d)).astype(np.float32))
    valid = (lane & torch.as_tensor(rng.random(lead + (ep,)) < 0.7)).to(torch.int32)
    msgs[valid == 0] = float("nan")   # a masked lane contributes nothing
    kw = dict(tile_v=tile_v, block_e=block_e)
    want = spmm.segment_spmm_tiles_plain(dst_local, msgs, valid, lay.block_tile,
                                         lay.n_tiles, **kw)
    args = [t.to(cuda) for t in (dst_local, msgs, valid, lay.block_tile)]
    before = spmm.segment_spmm_tiles.launches
    got = spmm.segment_spmm_tiles(*args, lay.n_tiles, **kw)
    torch.cuda.synchronize()
    assert spmm.segment_spmm_tiles.launches == before + 1
    assert got.shape == want.shape and not torch.isnan(got).any()
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


def test_segment_spmm_wrapper_rejects_bad_input(cuda):
    lay, lane, dst_local, _ = _layout_inputs(100, 700, 64, 128, 0)
    ep = lay.n_edges_padded
    args = dict(dst_local=dst_local.to(cuda), valid=lane.to(torch.int32).to(cuda),
                block_tile=lay.block_tile.to(cuda))
    msgs = torch.zeros((ep, 2), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        spmm.segment_spmm_tiles(args["dst_local"], msgs, args["valid"],
                                args["block_tile"], lay.n_tiles, tile_v=64, block_e=128)
    with pytest.raises(ValueError):  # mixed devices
        spmm.segment_spmm_tiles(args["dst_local"], msgs.float().cpu(), args["valid"],
                                args["block_tile"], lay.n_tiles, tile_v=64, block_e=128)


def _small_graph(dev, generator=power_law_temporal_graph):
    g = generator(n_vertices=2000, n_edges=30000, seed=5, device=dev)
    idx = build_tger(g, degree_cutoff=256)
    ts = g.t_start.cpu()
    t_hi = int(g.t_end.max())
    win = (int(ts.float().quantile(0.3)), t_hi)
    plan = plan_query(g, idx, win, access="scan", backend="pallas_tiled")
    return g, idx, win, plan


@pytest.mark.parametrize("kind", ["power_law", "transit"])
def test_pagerank_on_card_matches_cpu(cuda, kind):
    """PageRank on a tiled scan plan: one K3 launch per power iteration, and
    the card's ranks within the reference's PageRank tolerance of the CPU's
    (both sum in float64 and round once, so the power-law hub's 8,756
    in-edges do not drift)."""
    generator = {"transit": transit_temporal_graph,
                 "power_law": power_law_temporal_graph}[kind]
    n_iters = 30
    runs = []
    for dev in ("cpu", cuda):
        g, idx, win, plan = _small_graph(dev, generator)
        reset_launch_counts()
        pr = temporal_pagerank(g, win, idx, plan=plan, n_iters=n_iters)
        torch.cuda.synchronize()
        runs.append((pr.cpu(), launch_counts()))
    (p0, n0), (p1, n1) = runs
    assert n0["segment_spmm_tiles"] == 0
    assert n1["segment_spmm_tiles"] == n_iters
    torch.testing.assert_close(p1, p0, rtol=1e-5, atol=1e-7)


def test_bfs_and_cc_on_card_match_cpu(cuda):
    runs = []
    for dev in ("cpu", cuda):
        g, idx, win, plan = _small_graph(dev)
        reset_launch_counts()
        hops, arr = temporal_bfs(g, 0, win, idx, plan=plan)
        bfs_k1 = launch_counts()["segment_min_tiles"]
        labels = temporal_cc(g, win, idx, plan=plan)
        cc_k1 = launch_counts()["segment_min_tiles"] - bfs_k1
        runs.append((hops.cpu(), arr.cpu(), labels.cpu(), bfs_k1, cc_k1))
    (h0, a0, l0, b0, c0), (h1, a1, l1, b1, c1) = runs
    assert torch.equal(h0, h1) and torch.equal(a0, a1) and torch.equal(l0, l1)
    assert (b0, c0) == (0, 0) and b1 > 0 and c1 > 0
