"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  Integer
kernels (K1, K2) are held to bit-identity; the float sum kernel (K3) adds
with atomics in no fixed order and is held within rtol/atol 2e-4, the JAX
kernel sweep's tolerance.  The flash-decode kernel (K4) is held to its
plain version within rtol/atol 2e-5 in float32 (the reference's kernel
tolerance) and 2**-6 in bfloat16 (the plain version rounds q * scale and
the probabilities to bfloat16 as the reference does, the kernel keeps
them in float32; both round the output once), and in bfloat16 within one
ulp (rtol 2**-7, atol 2**-12) of the plain version on float32 copies of
its inputs, which is the kernel's own arithmetic.  The file
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
    fastest,
    temporal_bfs,
    temporal_cc,
    temporal_pagerank,
)
from repro_torch.core.edgemap import advance_index_ring, index_ring_view
from repro_torch.core.tger import window_positions_host
from repro_torch.engine import QueryBatch, QuerySpec
from repro_torch.data.generators import power_law_temporal_graph, transit_temporal_graph
from repro_torch.engine.backends import segments_for
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.kernels import segment_spmm as spmm
from repro_torch.kernels import temporal_edgemap as tem
from repro_torch.kernels import decode_attention as k4
from repro_torch.models import transformer as ttf
from repro_torch.serve import serve_batch, sliding_windows
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

SHAPES = [  # n_v, n_e, tile_v, block_e (as the JAX kernel sweep), destinations
    (100, 700, 64, 128, "uniform"),
    (700, 6000, 256, 512, "uniform"),
    (513, 2000, 128, 256, "uniform"),
    (64, 64, 64, 128, "uniform"),
    (50, 0, 64, 128, "uniform"),          # empty graph: one all-padding block
    # power-law destinations: a hub tile of ~300 blocks over five of K1's
    # 8192-slot CTAs, empty tiles between the owned ones
    (3000, 40000, 64, 128, "zipf"),
    (20000, 60000, 512, 1024, "zipf"),    # the main path's tile shape
    (40000, 30000, 4096, 2048, "zipf"),   # K1 fits 14 windows per CTA
    # tile_v not a multiple of 4 (one-element stores); blocks straddle K1's
    # CTAs and the slot count is odd (one-element loads)
    (701, 30000, 100, 301, "uniform"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _layout_inputs(n_v, n_e, tile_v, block_e, seed, law="uniform"):
    rng = np.random.default_rng(seed)
    dst = (rng.integers(0, n_v, n_e) if law == "uniform"
           else np.minimum(rng.zipf(1.8, n_e) - 1, n_v - 1))
    lay = ops.prepare_layout(dst, n_v, tile_v=tile_v, block_e=block_e)
    perm = lay.perm.numpy()
    seg = np.append(dst, 0)[np.where(perm >= 0, perm, n_e)]  # padding -> 0
    dst_local = torch.as_tensor((seg % tile_v).astype(np.int32))
    return lay, lay.perm >= 0, dst_local, rng


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e,law", SHAPES)
@pytest.mark.parametrize("n_windows", [0, 3, 31, 32, 33])   # 32 windows per CTA
@pytest.mark.parametrize("cand_kind", ["mixed", "all_inf", "all_finite"])
def test_segment_min_tiles_kernel_matches_plain(cuda, n_v, n_e, tile_v, block_e, law,
                                                n_windows, cand_kind):
    """Bit-identical to the plain version; "all_finite" is finite in every
    lane, padding included, over the whole int32 range below INF."""
    lay, lane, dst_local, rng = _layout_inputs(n_v, n_e, tile_v, block_e, n_e, law)
    shape = (n_windows, lay.n_edges_padded) if n_windows else (lay.n_edges_padded,)
    if cand_kind == "all_finite":
        cand = torch.as_tensor(rng.integers(-2**31, tem.INT_INF, shape).astype(np.int32))
    elif cand_kind == "all_inf":
        cand = torch.full(shape, tem.INT_INF, dtype=torch.int32)
    else:
        cand = rng.integers(0, 1000, shape).astype(np.int32)
        cand[..., rng.random(lay.n_edges_padded) < 0.3] = tem.INT_INF
        cand = torch.where(lane, torch.as_tensor(cand), tem.INT_INF)
    want = tem.segment_min_tiles_plain(dst_local, cand, lay.block_tile,
                                       lay.n_tiles, tile_v=tile_v, block_e=block_e)
    args = (dst_local.to(cuda), cand.to(cuda), lay.block_tile.to(cuda), lay.n_tiles)
    before = tem.segment_min_tiles.launches
    got = tem.segment_min_tiles(*args, tile_v=tile_v, block_e=block_e)
    again = tem.segment_min_tiles(*args, tile_v=tile_v, block_e=block_e)
    torch.cuda.synchronize()
    assert tem.segment_min_tiles.launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again.cpu(), want)   # the scratch and counters left at zero


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e,law", SHAPES)
@pytest.mark.parametrize("strict", [False, True])
def test_relax_min_tiles_kernel_matches_plain(cuda, n_v, n_e, tile_v, block_e, law,
                                              strict):
    lay, lane, dst_local, rng = _layout_inputs(n_v, n_e, tile_v, block_e, n_e + 1, law)
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

@pytest.mark.parametrize("n_v,n_e,tile_v,block_e,law", SHAPES)
@pytest.mark.parametrize("d", [1, 16, 130])
@pytest.mark.parametrize("n_windows", [0, 1, 3])
def test_segment_spmm_tiles_kernel_matches_plain(cuda, n_v, n_e, tile_v, block_e, law, d,
                                                 n_windows):
    lay, lane, dst_local, rng = _layout_inputs(n_v, n_e, tile_v, block_e, n_e + d, law)
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


def _skewed_dst(kind, rng):
    """Destinations of the K3 layouts that stress the flush: (dst, n_v,
    tile_v, block_e)."""
    if kind == "one_slot":       # every edge on one vertex: one tile of 24 blocks
        return np.full(3000, 37), 300, 64, 128
    if kind == "zipf_hub":       # power-law destinations: a hub tile over many CTAs
        return np.minimum(rng.zipf(1.8, 40000) - 1, 4999), 5000, 128, 128
    if kind == "main_layout":    # the main path's tile_v and block_e, a hub over many CTAs
        return np.minimum(rng.zipf(1.8, 200000) - 1, 19999), 20000, 512, 1024
    if kind == "empty_tiles":    # edges in tiles 0, 3 and 9 only, of 12
        ids = np.concatenate([np.arange(0, 64), np.arange(192, 256), np.arange(576, 640)])
        return rng.choice(ids, 2500), 768, 64, 128
    # uniform over many small tiles: each CTA's 8 blocks span 8 tiles
    return rng.integers(0, 4000, 6000), 4000, 64, 128


@pytest.mark.parametrize("kind", ["one_slot", "zipf_hub", "main_layout", "empty_tiles",
                                  "many_tiles"])
@pytest.mark.parametrize("d", [1, 16, 130])
@pytest.mark.parametrize("n_windows", [0, 1, 3])
def test_segment_spmm_tiles_kernel_flush(cuda, kind, d, n_windows):
    """Layouts whose tiles are shared by many CTAs, owned by one, or own no
    block; NaNs in masked lanes stay out; two calls agree (the scratch and
    counters are left at zero)."""
    rng = np.random.default_rng(d + n_windows)
    dst, n_v, tile_v, block_e = _skewed_dst(kind, rng)
    lay = ops.prepare_layout(dst, n_v, tile_v=tile_v, block_e=block_e)
    perm = lay.perm.numpy()
    seg = np.append(dst, 0)[np.where(perm >= 0, perm, len(dst))]
    dst_local = torch.as_tensor((seg % tile_v).astype(np.int32))
    lead = (n_windows,) if n_windows else ()
    ep = lay.n_edges_padded
    msgs = torch.as_tensor(rng.random(lead + (ep, d)).astype(np.float32))
    valid = ((lay.perm >= 0) & torch.as_tensor(rng.random(lead + (ep,)) < 0.8)).to(torch.int32)
    msgs[valid == 0] = float("nan")
    kw = dict(tile_v=tile_v, block_e=block_e)
    want = spmm.segment_spmm_tiles_plain(dst_local, msgs, valid, lay.block_tile,
                                         lay.n_tiles, **kw)
    args = [t.to(cuda) for t in (dst_local, msgs, valid, lay.block_tile)]
    before = spmm.segment_spmm_tiles.launches
    got = spmm.segment_spmm_tiles(*args, lay.n_tiles, **kw)
    again = spmm.segment_spmm_tiles(*args, lay.n_tiles, **kw)
    torch.cuda.synchronize()
    assert spmm.segment_spmm_tiles.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(again.cpu(), want, rtol=2e-4, atol=2e-4)


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


def test_fastest_on_card_matches_cpu(cuda):
    """fastest's 32-departure ladder: one K1 launch per round with the
    departures on grid y (W = 32), equal to the CPU run."""
    runs = []
    for dev in ("cpu", cuda):
        g, idx, win, plan = _small_graph(dev)
        reset_launch_counts()
        f = fastest(g, 0, win, idx, plan=plan)
        runs.append((f.cpu(), launch_counts()["segment_min_tiles"]))
    (f0, n0), (f1, n1) = runs
    assert torch.equal(f0, f1) and n0 == 0 and n1 > 0


@pytest.mark.parametrize("alg", ["ea", "cc"])
def test_laddered_on_card_matches_dense(cuda, alg):
    """The frontier ladder on a tiled scan plan (cap 64): bit-identical to
    the dense solve on the card and to the CPU's laddered solve, its
    segment record equal to the CPU's, and K1 launched once per dense
    round of the ladder (its sparse rounds are row-wise scatters)."""
    from repro_torch.core.algorithms import paths, connectivity
    from repro_torch.core.algorithms import earliest_arrival_over_view, temporal_cc_over_view
    from repro_torch.core.edgemap import union_window, view_for_plan
    from repro_torch.engine import frontier

    module = paths if alg == "ea" else connectivity
    runs = []
    for dev in ("cpu", cuda):
        g, idx, _, _ = _small_graph(dev)
        t_hi = int(g.t_end.max())
        wins = sliding_windows(t_hi, (t_hi - int(g.t_start.min())) // 3, 1000, 3)
        out = {}
        for ladder in (0, 64):
            plan = plan_query(g, idx, windows=wins, access="scan", backend="pallas_tiled",
                              ladder=ladder)
            edges = view_for_plan(g, idx, union_window(wins), plan)
            segs = []

            def spy(*args, segments=None, **kw):
                return frontier.run_laddered(*args, segments=segs, **kw)

            reset_launch_counts()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module, "run_laddered", spy)
                if alg == "ea":
                    res = earliest_arrival_over_view(edges, wins, plan=plan,
                                                     n_vertices=g.n_vertices,
                                                     sources=[0, 1, 2])
                else:
                    res = temporal_cc_over_view(edges, wins, plan=plan,
                                                n_vertices=g.n_vertices)
            out[ladder] = (res.cpu(), segs, launch_counts()["segment_min_tiles"])
        runs.append(out)
    cpu, card = runs
    assert torch.equal(card[64][0], card[0][0]) and torch.equal(card[64][0], cpu[64][0])
    assert card[64][1] == cpu[64][1] and card[64][1]
    dense_rounds = sum(n for kind, _, _, n in card[64][1] if kind == "dense")
    assert cpu[64][2] == 0 and card[64][2] == dense_rounds


def test_serve_batch_on_card_matches_cpu(cuda):
    """Three advances of a multi-tenant batch on a tiled scan plan: the
    integer groups equal the CPU run's, PageRank within its tolerance, and
    K1 and K3 launch inside the advances."""
    runs = []
    for dev in ("cpu", cuda):
        g, idx, _, _ = _small_graph(dev)
        t_hi = int(g.t_end.max())
        width = (t_hi - int(g.t_start.min())) // 10
        state, out, counts = None, [], []
        for step in range(3):
            wins = sliding_windows(t_hi - (2 - step) * width // 4, width, width // 4, 3)
            batch = QueryBatch.make(
                [QuerySpec.make("earliest_arrival", tuple(w), sources=[0, 1]) for w in wins]
                + [QuerySpec.make("bfs", tuple(wins[0]), sources=0),
                   QuerySpec.make("cc", tuple(wins[1])),
                   QuerySpec.make("pagerank", tuple(wins[0]), n_iters=10)])
            reset_launch_counts()
            res, state = serve_batch(g, batch, idx, state=state, access="scan",
                                     backend="pallas_tiled")
            counts.append(launch_counts())
            out.append(res)
        runs.append((out, counts, state.last_advance))
    (o0, c0, a0), (o1, c1, a1) = runs
    assert a0 == a1 == "reuse"
    for r0, r1 in zip(o0, o1):
        for x, y in zip(r0[:2], r1[:2]):
            for u, v in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(u, v.cpu())
        assert torch.equal(r0[2], r1[2].cpu())
        torch.testing.assert_close(r1[3].cpu(), r0[3], rtol=1e-5, atol=1e-7)
    assert all(set(c.values()) == {0} for c in c0)
    assert all(c["segment_min_tiles"] > 0 and c["segment_spmm_tiles"] == 10 for c in c1)


def test_index_ring_advance_on_card_matches_cold_build(cuda):
    g, idx, _, _ = _small_graph(cuda)
    t_hi = int(g.t_end.max())
    lo, hi = window_positions_host(idx, (t_hi - 4000, t_hi - 2000))
    lo2, hi2 = window_positions_host(idx, (t_hi - 3000, t_hi - 1000))
    cap = 1 << max(hi - lo, hi2 - lo2, lo2 - lo).bit_length()
    ring = index_ring_view(g, idx, lo, hi, capacity=cap)
    ring = advance_index_ring(g, idx, ring, lo, lo2, hi2, capacity=cap)
    cold = index_ring_view(g, idx, lo2, hi2, capacity=cap)
    assert all(torch.equal(a, b) for a, b in zip(ring, cold))


# -- K4: decode_attention ------------------------------------------------------

DECODE_SHAPES = [  # B, S, H, KH, Dh: the JAX kernel tests, one-element loads, phi4-mini
    (2, 64, 4, 2, 16),
    (3, 100, 8, 4, 32),
    (1, 33, 2, 1, 8),
    (2, 128, 8, 8, 16),
    (2, 40, 4, 2, 12),       # bfloat16 rows not a 16-byte multiple: scalar loads
    (8, 2048, 24, 8, 128),   # phi4-mini's decode shape at 2048 positions
]
K4_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=2**-6, atol=2**-6)}


def _decode_inputs(B, S, H, KH, Dh, dtype, seed, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
               .to(device=device, dtype=dtype)
               for shape in ((B, H, Dh), (B, S, KH, Dh), (B, S, KH, Dh)))
    lens = torch.as_tensor(rng.integers(1, S + 1, B).astype(np.int32), device=device)
    return q, k, v, lens


@pytest.mark.parametrize("B,S,H,KH,Dh", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, B, S, H, KH, Dh, dtype):
    q, k, v, lens = _decode_inputs(B, S, H, KH, Dh, dtype, S + Dh, cuda)
    want = k4.decode_attention_plain(q, k, v, lens)
    before = k4.decode_attention.launches
    got = k4.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert k4.decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **K4_TOL[dtype])


# K4 at float32 copies of its inputs, rounded once: the kernel's own
# arithmetic, so within one bfloat16 ulp in bfloat16
K4_COPY_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
               torch.bfloat16: dict(rtol=2**-7, atol=2**-12)}
# lengths 0, 1, the smallest split size (64) +- 1, two splits +- 1, and S
EDGE_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 300]


def _check_k4(q, k, v, lens):
    want = k4.decode_attention_plain(q.float(), k.float(), v.float(), lens).to(q.dtype)
    before = k4.decode_attention.launches
    got = k4.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert k4.decode_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **K4_COPY_TOL[q.dtype])


@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_groups_and_edge_lengths(cuda, G, Dh, dtype):
    B, S, KH = len(EDGE_LENGTHS), 300, 2
    q, k, v, _ = _decode_inputs(B, S, KH * G, KH, Dh, dtype, G * Dh, cuda)
    lens = torch.tensor(EDGE_LENGTHS, dtype=torch.int32, device=cuda)
    _check_k4(q, k, v, lens)


def test_decode_attention_kernel_calls_in_turn_and_on_a_side_stream(cuda):
    """Back-to-back calls with other lengths (other split counts per row),
    then calls on a side stream and back on the default stream: the split
    counters are left at zero by every call."""
    B, S, H, KH, Dh = 8, 2048, 24, 8, 128
    q, k, v, _ = _decode_inputs(B, S, H, KH, Dh, torch.bfloat16, 11, cuda)
    rng = np.random.default_rng(12)
    for _ in range(3):
        lens = torch.as_tensor(rng.integers(0, S + 1, B).astype(np.int32), device=cuda)
        _check_k4(q, k, v, lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lens = torch.as_tensor(rng.integers(1, S + 1, B).astype(np.int32), device=cuda)
        _check_k4(q, k, v, lens)
    torch.cuda.current_stream().wait_stream(side)
    lens = torch.as_tensor(rng.integers(1, S + 1, B).astype(np.int32), device=cuda)
    _check_k4(q, k, v, lens)


def test_decode_attention_kernel_respects_lengths(cuda):
    """Entries past cache_len do not reach the output; a zero-length row
    gives zeros."""
    q, k, v, _ = _decode_inputs(2, 300, 4, 2, 16, torch.float32, 9, cuda)
    lens = torch.tensor([0, 10], dtype=torch.int32, device=cuda)
    out1 = k4.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:] = 99.0
    v2[:, 10:] = -99.0
    out2 = k4.decode_attention(q, k2, v2, lens)
    assert (out1[0] == 0).all()
    torch.testing.assert_close(out1, out2, rtol=0, atol=1e-6)


def test_decode_attention_wrapper_rejects_bad_input(cuda):
    q, k, v, lens = _decode_inputs(2, 16, 18, 2, 16, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="group"):  # G = 9 > 8
        k4.decode_attention(q, k, v, lens)
    q, k, v, lens = _decode_inputs(2, 16, 4, 2, 256, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="d_head"):
        k4.decode_attention(q, k, v, lens)
    q, k, v, lens = _decode_inputs(2, 16, 4, 2, 16, torch.float32, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k4.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lens)
    with pytest.raises(TypeError):
        k4.decode_attention(q.half(), k.half(), v.half(), lens)


def _smoke_lm(tied: bool):
    cfg = ttf.LMConfig(name="smoke", n_layers=2, d_model=48, n_heads=4,
                       n_kv_heads=1 if tied else 2, d_head=16, d_ff=128, vocab=128,
                       dtype=torch.float32, q_chunk=16, kv_chunk=16, tie_embeddings=tied)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    return ttf.init_lm(cfg, gen, "cpu")


@pytest.mark.parametrize("tied", [False, True])
def test_decode_step_on_card_matches_cpu(cuda, tied):
    """prefill and one ragged decode step, card (K4) against CPU (plain),
    float32 matmuls in full precision: logits within rtol 1e-5 plus 1e-4 of
    the largest (the CPU tests' tolerance against JAX, doubled for cuBLAS's
    summation order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _smoke_lm(tied)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, 128, (3, 32)).astype(np.int32))
    nxt = torch.as_tensor(rng.integers(0, 128, 3).astype(np.int32))
    lens = torch.tensor([32, 17, 1], dtype=torch.int32)
    out = []
    for dev in ("cpu", cuda):
        m = model.to(dev)
        reset_launch_counts()
        _, cache = ttf.prefill(m, toks.to(dev), max_seq=48)
        logits, cache = ttf.decode_step(m, cache, nxt.to(dev), lens.to(dev))
        torch.cuda.synchronize()
        out.append((logits.cpu(), cache["k"].cpu(), launch_counts()["decode_attention"]))
    (l0, k0, n0), (l1, k1, n1) = out
    assert (n0, n1) == (0, model.cfg.n_layers)
    for got, want in ((l1, l0), (k1, k0)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * float(want.abs().max()))


def test_serve_engine_on_card_matches_cpu(cuda):
    """The engine on the card emits the CPU run's tokens, and launches K4
    once per layer per decode step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _smoke_lm(False)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (5, 16, 9, 12, 7)]
    budgets = [6, 1, 0, 9, 4]
    runs = []
    for dev in ("cpu", cuda):
        engine = ServeEngine(model.to(dev), batch_slots=2, max_seq=32)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=b)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        for r in reqs:
            engine.submit(r)
        reset_launch_counts()
        stats = engine.run()
        runs.append(([r.generated for r in reqs], stats,
                     launch_counts()["decode_attention"]))
    (t0, s0, n0), (t1, s1, n1) = runs
    assert t1 == t0 and s1 == s0
    assert s1.tokens_generated == sum(budgets) and s1.requests_completed == 5
    assert n0 == 0 and n1 == model.cfg.n_layers * s1.steps
