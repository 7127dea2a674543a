"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports no JAX (the machine with the card has none); the plain versions it
compares against are held to the JAX kernels by ``test_torch_kernels.py``.
Run on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_tger, plan_query
from repro_torch.core.algorithms import earliest_arrival
from repro_torch.data.generators import power_law_temporal_graph
from repro_torch.engine.backends import segments_for
from repro_torch.kernels import ops
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
        tem.reset_launch_counts()
        a = earliest_arrival(g, 0, win, idx, plan=plan)
        b = ops.earliest_arrival_kernel(
            g, ops.prepare_layout(g.dst, g.n_vertices), 0, win)
        results.append((a.cpu(), b.cpu(), tem.launch_counts()))
        if dev != "cpu":
            assert segments_for(plan, g.dst, use_layout=True).tiles is not None
    (a0, b0, n0), (a1, b1, n1) = results
    assert torch.equal(a0, a1) and torch.equal(b0, b1) and torch.equal(a0, b0)
    assert n0 == {"segment_min_tiles": 0, "temporal_relax_min_tiles": 0}
    assert n1["segment_min_tiles"] > 0 and n1["temporal_relax_min_tiles"] > 0
