"""The plain versions of the port's kernels, and the combine layer around
them, against the JAX package's Pallas kernels run with ``interpret=True``
on the same inputs.  Integer results: every comparison is exact.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.engine.backends as jback
import repro.engine.plan as jplan
import repro.kernels.ops as jops
import repro.kernels.ref as jref
import repro.kernels.temporal_edgemap as jtem
import repro_torch.engine.backends as tback
import repro_torch.engine.plan as tplan
import repro_torch.kernels.ops as tops
import repro_torch.kernels.ref as tref
import repro_torch.kernels.temporal_edgemap as ttem
from repro.data.generators import power_law_temporal_graph as jpower
from repro.data.generators import synthetic_temporal_graph as jsynth
from repro_torch.data.generators import power_law_temporal_graph as tpower
from repro_torch.data.generators import synthetic_temporal_graph as tsynth
from test_torch_common import CPU, as_np

INF = ttem.INT_INF
SHAPES = [  # the sweep of tests/test_kernels.py, plus the empty layout
    (100, 700, 64, 128),
    (700, 6000, 256, 512),
    (513, 2000, 128, 256),     # vertex count not a multiple of tile_v
    (64, 64, 64, 128),         # fewer edges than one block
    (50, 0, 64, 128),          # empty graph: one all-padding block
]


def _tile_inputs(n_v, n_e, tile_v, block_e, seed):
    """Layout-ordered kernel inputs: dst_local, a candidate with padding and
    masked lanes at INF, the edge fields, and the block->tile map."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_v, n_e)
    lay = jops.prepare_layout(dst, n_v, tile_v=tile_v, block_e=block_e)
    ep = lay.n_edges_padded
    lane = lay.perm >= 0
    seg = np.append(dst, 0)[np.where(lane, lay.perm, n_e)]
    ts = np.where(lane, rng.integers(0, 1000, ep), 0)
    inputs = dict(
        dst_local=(seg % tile_v).astype(np.int32),
        cand=np.where(lane & (rng.random(ep) < 0.7), rng.integers(0, 1000, ep),
                      INF).astype(np.int32),
        arr=np.where(rng.random(ep) < 0.8, rng.integers(0, 600, ep), INF).astype(np.int32),
        ts=ts.astype(np.int32),
        te=(ts + np.where(lane, rng.integers(0, 100, ep), 0)).astype(np.int32),
        valid=lane.astype(np.int32),
    )
    return lay, inputs


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e", SHAPES)
def test_segment_min_tiles_plain_matches_pallas(n_v, n_e, tile_v, block_e):
    lay, x = _tile_inputs(n_v, n_e, tile_v, block_e, n_e)
    want = jtem.segment_min_tiles(
        jnp.asarray(x["dst_local"]), jnp.asarray(x["cand"]),
        jnp.asarray(lay.block_tile), lay.n_tiles, tile_v=tile_v, block_e=block_e,
        interpret=True)
    before = ttem.segment_min_tiles.launches
    got = ttem.segment_min_tiles(_t(x["dst_local"]), _t(x["cand"]),
                                 _t(lay.block_tile), lay.n_tiles,
                                 tile_v=tile_v, block_e=block_e)
    assert ttem.segment_min_tiles.launches == before  # CPU: plain version
    assert got.shape == (lay.n_tiles, tile_v)
    assert (as_np(got) == np.asarray(want)).all()


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e", SHAPES)
@pytest.mark.parametrize("strict", [False, True])
def test_relax_min_tiles_plain_matches_pallas(n_v, n_e, tile_v, block_e, strict):
    lay, x = _tile_inputs(n_v, n_e, tile_v, block_e, n_e + 1)
    window = (100, 900)
    names = ("dst_local", "arr", "ts", "te", "valid")
    want = jtem.temporal_relax_min_tiles(
        *(jnp.asarray(x[k]) for k in names), jnp.asarray(lay.block_tile),
        jnp.asarray(window, jnp.int32), lay.n_tiles, tile_v=tile_v,
        block_e=block_e, strict=strict, interpret=True)
    got = ttem.temporal_relax_min_tiles(
        *(_t(x[k]) for k in names), _t(lay.block_tile), window, lay.n_tiles,
        tile_v=tile_v, block_e=block_e, strict=strict)
    assert (as_np(got) == np.asarray(want)).all()


def test_plain_ignores_out_of_range_lanes():
    """A local id outside [0, tile_v) never lands, as in the Pallas tree."""
    lay, x = _tile_inputs(100, 700, 64, 128, 3)
    d = x["dst_local"].copy()
    d[::7] = 64
    d[1::11] = -1
    want = jtem.segment_min_tiles(jnp.asarray(d), jnp.asarray(x["cand"]),
                                  jnp.asarray(lay.block_tile), lay.n_tiles,
                                  tile_v=64, block_e=128, interpret=True)
    got = ttem.segment_min_tiles_plain(_t(d), _t(x["cand"]), _t(lay.block_tile),
                                       lay.n_tiles, tile_v=64, block_e=128)
    assert (as_np(got) == np.asarray(want)).all()


def test_wrappers_check_inputs():
    lay, x = _tile_inputs(100, 700, 64, 128, 4)
    d, c, bt = _t(x["dst_local"]), _t(x["cand"]), _t(lay.block_tile)
    with pytest.raises(TypeError):
        ttem.segment_min_tiles(d, c.long(), bt, lay.n_tiles, tile_v=64, block_e=128)
    with pytest.raises(ValueError):
        ttem.segment_min_tiles(d[:-1], c, bt, lay.n_tiles, tile_v=64, block_e=128)
    with pytest.raises(ValueError):
        ttem.segment_min_tiles(d, c[::2].repeat(2), bt, lay.n_tiles, tile_v=64,
                               block_e=128)  # fine shape, so it runs ...
        ttem.segment_min_tiles(d, torch.stack([c, c]).t(), bt, lay.n_tiles,
                               tile_v=64, block_e=128)  # ... a strided view does not
    with pytest.raises(ValueError):
        ttem.temporal_relax_min_tiles(d, c, c, c[:-1], c, bt, (0, 1), lay.n_tiles,
                                      tile_v=64, block_e=128)


@pytest.mark.parametrize("kernel", ["segment_min_tiles", "temporal_relax_min_tiles"])
def test_wrappers_reject_unordered_block_tile(kernel):
    """The kernels finish a tile when its blocks end, so they need a tile's
    blocks consecutive (block_tile nondecreasing, as the layout builds it);
    the wrappers check it on the CPU.  The Pallas kernel, run in interpret
    mode, takes any order."""
    lay, x = _tile_inputs(700, 6000, 256, 512, 5)
    bt = lay.block_tile.copy()
    assert (np.diff(bt) >= 0).all() and bt[0] != bt[-1]
    bt[[0, -1]] = bt[[-1, 0]]
    d, c = _t(x["dst_local"]), _t(x["cand"])
    with pytest.raises(ValueError, match="nondecreasing"):
        if kernel == "segment_min_tiles":
            ttem.segment_min_tiles(d, torch.stack([c, c]), _t(bt), lay.n_tiles,
                                   tile_v=256, block_e=512)
        else:
            ttem.temporal_relax_min_tiles(d, _t(x["arr"]), _t(x["ts"]), _t(x["te"]),
                                          _t(x["valid"]), _t(bt), (0, 1000),
                                          lay.n_tiles, tile_v=256, block_e=512)


@pytest.mark.parametrize("n_windows,tile_v,want", [
    (1, 512, 1), (8, 512, 8), (32, 512, 32),   # one chunk up to 32 windows
    (33, 512, 17), (65, 512, 22),              # then equal chunks
    (32, 4096, 11), (3, 12288, 3), (5, 12288, 3),  # 224 KB holds 14 and 4 tiles
])
def test_windows_per_cta(n_windows, tile_v, want):
    assert ttem.windows_per_cta(n_windows, tile_v) == want


def test_tile_starts_mark_the_tiles_that_own_no_block():
    """Each tile's first block, from the layout (one per layout, cached):
    equal starts mark the tiles that own no block, which the tile-min
    kernels store as INF themselves."""
    ids = np.concatenate([np.arange(0, 64), np.arange(192, 256), np.arange(576, 640)])
    dst = np.random.default_rng(0).choice(ids, 2500)       # tiles 0, 3 and 9 of 12
    lay = tops.prepare_layout(dst, 768, tile_v=64, block_e=128)
    starts = tops.tile_starts(lay.block_tile, lay.n_tiles)
    assert starts is tops.tile_starts(lay.block_tile, lay.n_tiles)   # derived once
    assert starts.dtype == torch.int32
    np.testing.assert_array_equal(
        as_np(starts), np.searchsorted(as_np(lay.block_tile), np.arange(13)))
    owned = as_np(starts[1:] != starts[:-1])
    np.testing.assert_array_equal(np.flatnonzero(owned), [0, 3, 9])


def _tiled_plans(n_v=300, n_e=5000, seed=2, tile_v=128, block_e=256):
    jg = jpower(n_v, n_e, seed=seed)
    tg = tpower(n_v, n_e, seed=seed, device=CPU)
    jl = jops.prepare_layout(np.asarray(jg.dst), n_v, tile_v, block_e)
    tl = tops.prepare_layout(tg.dst, n_v, tile_v, block_e)
    jp = jplan.make_plan("scan", "pallas_tiled", layout=jl, n_edges=n_e)
    tp = tplan.make_plan("scan", "pallas_tiled", layout=tl, n_edges=n_e)
    return jg, tg, jp, tp


@pytest.mark.parametrize("n_windows", [1, 5])
def test_windowed_combine_matches_pallas(n_windows):
    """Batched tiled combine (one K1 launch for all W windows here, a
    ``lax.map`` of launches there) against the JAX backend."""
    jg, tg, jp, tp = _tiled_plans()
    rng = np.random.default_rng(n_windows)
    vals = rng.integers(0, 10_000, (n_windows, jg.n_edges)).astype(np.int32)
    masks = rng.random((n_windows, jg.n_edges)) < 0.6
    want = jback.PallasTiledBackend()._combine_min_windows(
        jp, jnp.asarray(vals), jg.dst, jg.n_vertices, jnp.asarray(masks))
    got = tback.PallasTiledBackend().combine_windows(
        tp, _t(vals), tg.dst, tg.n_vertices, "min", masks=_t(masks))
    assert (as_np(got) == np.asarray(want)).all()
    seg = tback.segment_combine_windows(_t(vals), tg.dst, tg.n_vertices, "min",
                                        masks=_t(masks))
    assert (as_np(seg) == np.asarray(want)).all()


@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_segment_combine_matches_jax(op):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 40, 600)
    mask = rng.random(600) < 0.7
    for vals in (rng.integers(-1000, 1000, 600).astype(np.int32),
                 rng.standard_normal(600).astype(np.float32)):
        want = jback.segment_combine(jnp.asarray(vals), jnp.asarray(ids), 50, op,
                                     mask=jnp.asarray(mask))
        got = tback.segment_combine(_t(vals), _t(ids), 50, op, mask=_t(mask))
        if vals.dtype == np.float32 and op == "sum":
            np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
        else:
            assert (as_np(got) == np.asarray(want)).all()
    vals = rng.integers(0, 100, (3, 600)).astype(np.int32)
    masks = rng.random((3, 600)) < 0.5
    want = jback.segment_combine_windows(jnp.asarray(vals), jnp.asarray(ids), 50, op,
                                         masks=jnp.asarray(masks))
    got = tback.segment_combine_windows(_t(vals), _t(ids), 50, op, masks=_t(masks))
    assert (as_np(got) == np.asarray(want)).all()


def test_combine_for_plan_routes():
    jg, tg, jp, tp = _tiled_plans()
    rng = np.random.default_rng(1)
    vals = _t(rng.integers(0, 10_000, tg.n_edges).astype(np.int32))
    mask = _t(rng.random(tg.n_edges) < 0.5)
    seg = tback.segment_combine(vals, tg.dst, tg.n_vertices, "min", mask=mask)
    tiled = tback.combine_for_plan(tp, vals, tg.dst, tg.n_vertices, "min", mask=mask,
                                   use_layout=True)
    assert torch.equal(seg, tiled)
    assert tback.segments_for(tp, tg.dst, use_layout=True).tiles is not None
    assert tback.segments_for(tp, tg.dst, use_layout=False).tiles is None
    # a float32 sum on the tiled backend runs K3 (its plain version here):
    # the layout's summation order, so equal to the segment path within
    # float32 rounding; a float64 sum and an int32 sum take the segment path
    fv = vals.float()
    np.testing.assert_allclose(
        as_np(tback.combine_for_plan(tp, fv, tg.dst, tg.n_vertices, "sum",
                                     mask=mask, use_layout=True)),
        as_np(tback.segment_combine(fv, tg.dst, tg.n_vertices, "sum", mask=mask)),
        rtol=1e-6)
    for other in (vals.double(), vals):
        assert torch.equal(
            tback.combine_for_plan(tp, other, tg.dst, tg.n_vertices, "sum",
                                   use_layout=True),
            tback.segment_combine(other, tg.dst, tg.n_vertices, "sum"))


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e", SHAPES[:4])
def test_ops_relax_min_matches_jax(n_v, n_e, tile_v, block_e):
    jg = jsynth(n_v, n_e, seed=n_e)
    tg = tsynth(n_v, n_e, seed=n_e, device=CPU)
    jl = jops.prepare_layout(np.asarray(jg.dst), n_v, tile_v=tile_v, block_e=block_e)
    tl = tops.prepare_layout(tg.dst, n_v, tile_v=tile_v, block_e=block_e)
    rng = np.random.default_rng(0)
    arrival = rng.integers(0, 1000, n_v).astype(np.int32)
    frontier = rng.random(n_v) < 0.5
    ts = np.asarray(jg.t_start)
    win = (int(np.quantile(ts, 0.2)), int(np.quantile(ts, 0.9)))
    for strict in (False, True):
        want = jops.relax_min(jl, jg.dst, jnp.asarray(arrival), jg.src, jg.t_start,
                              jg.t_end, jnp.asarray(frontier), win, strict=strict)
        got = tops.relax_min(tl, tg.dst, _t(arrival), tg.src, tg.t_start, tg.t_end,
                             _t(frontier), win, strict=strict)
        assert (as_np(got) == np.asarray(want)).all()
    arr_src = torch.where(_t(frontier), _t(arrival), INF)[tg.src.long()]
    ref = tref.temporal_relax_min_ref(tg.dst, arr_src, tg.t_start, tg.t_end,
                                      torch.ones(n_e, dtype=torch.bool), win, n_v)
    jr = jref.temporal_relax_min_ref(
        jg.dst, jnp.where(jnp.asarray(frontier), jnp.asarray(arrival), INF)[jg.src],
        jg.t_start, jg.t_end, jnp.ones(n_e, bool), win, n_v)
    assert (as_np(ref) == np.asarray(jr)).all()
    assert (as_np(ref) == as_np(tops.relax_min(tl, tg.dst, _t(arrival), tg.src,
                                                tg.t_start, tg.t_end, _t(frontier),
                                                win))).all()


def test_ops_earliest_arrival_kernel_matches_jax():
    jg = jpower(300, 4000, seed=41)
    tg = tpower(300, 4000, seed=41, device=CPU)
    jl = jops.prepare_layout(np.asarray(jg.dst), 300, tile_v=128, block_e=256)
    tl = tops.prepare_layout(tg.dst, 300, tile_v=128, block_e=256)
    ts = np.asarray(jg.t_start)
    win = (int(np.quantile(ts, 0.4)), int(np.asarray(jg.t_end).max()))
    src = int(np.argmax(np.asarray(jg.out_degree)))
    for strict in (False, True):
        want = jops.earliest_arrival_kernel(jg, jl, src, win, strict=strict)
        got = tops.earliest_arrival_kernel(tg, tl, src, win, strict=strict)
        assert (as_np(got) == np.asarray(want)).all()
