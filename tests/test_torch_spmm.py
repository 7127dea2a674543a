"""The plain version of the tiled segment-sum kernel (K3), and the sum path of
the tiled backend around it, against the JAX package's Pallas kernel run
with ``interpret=True`` on the same inputs.

Tolerance: rtol 2e-4 / atol 2e-4, the JAX kernel sweep's own
(``tests/test_kernels.py``): the one-hot matrix product and ``index_add_``
sum in different orders.  The CUDA kernel is held to this plain version on
the card by ``tests/test_torch_cuda.py``.
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
import repro.kernels.segment_spmm as jspmm
import repro_torch.engine.backends as tback
import repro_torch.engine.plan as tplan
import repro_torch.kernels.ops as tops
import repro_torch.kernels.ref as tref
import repro_torch.kernels.segment_spmm as tspmm
from repro.data.generators import power_law_temporal_graph as jpower
from repro.data.generators import synthetic_temporal_graph as jsynth
from repro_torch.data.generators import power_law_temporal_graph as tpower
from repro_torch.data.generators import synthetic_temporal_graph as tsynth
from test_torch_common import CPU, as_np

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [  # n_v, n_e, tile_v, block_e: the K1 sweep, and the empty layout
    (100, 700, 64, 128),
    (700, 6000, 256, 512),
    (513, 2000, 128, 256),
    (64, 64, 64, 128),
    (50, 0, 64, 128),
]


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _layout_inputs(n_v, n_e, tile_v, block_e, d, n_windows, seed):
    """Layout-ordered K3 inputs: dst_local, messages [(W,) Ep, D] and a
    valid mask [(W,) Ep] that is off on padding and on ~30% of the edges."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_v, n_e)
    lay = jops.prepare_layout(dst, n_v, tile_v=tile_v, block_e=block_e)
    ep = lay.n_edges_padded
    lane = lay.perm >= 0
    seg = np.append(dst, 0)[np.where(lane, lay.perm, n_e)]
    lead = (n_windows,) if n_windows else ()
    msgs = rng.standard_normal(lead + (ep, d)).astype(np.float32)
    valid = (lane & (rng.random(lead + (ep,)) < 0.7)).astype(np.int32)
    return lay, (seg % tile_v).astype(np.int32), msgs, valid


def _jax_tiles(lay, dst_local, msgs, valid):
    return np.asarray(jspmm.segment_spmm_tiles(
        jnp.asarray(dst_local), jnp.asarray(msgs), jnp.asarray(valid),
        jnp.asarray(lay.block_tile), lay.n_tiles, tile_v=lay.tile_v,
        block_e=lay.block_e, interpret=True))


@pytest.mark.parametrize("n_v,n_e,tile_v,block_e", SHAPES)
@pytest.mark.parametrize("d", [1, 16])
def test_segment_spmm_tiles_plain_matches_pallas(n_v, n_e, tile_v, block_e, d):
    lay, dst_local, msgs, valid = _layout_inputs(n_v, n_e, tile_v, block_e, d, 0,
                                                 n_e + d)
    want = _jax_tiles(lay, dst_local, msgs, valid)
    before = tspmm.segment_spmm_tiles.launches
    got = tspmm.segment_spmm_tiles(_t(dst_local), _t(msgs), _t(valid),
                                   _t(lay.block_tile), lay.n_tiles,
                                   tile_v=tile_v, block_e=block_e)
    assert tspmm.segment_spmm_tiles.launches == before  # CPU: plain version
    assert got.shape == (lay.n_tiles, tile_v, d) and got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), want, **TOL)


@pytest.mark.parametrize("n_windows", [2, 5])
def test_segment_spmm_tiles_windows_match_separate_pallas_calls(n_windows):
    """W windows in one call here; W separate kernel calls there."""
    lay, dst_local, msgs, valid = _layout_inputs(700, 6000, 256, 512, 3,
                                                 n_windows, n_windows)
    got = tspmm.segment_spmm_tiles(_t(dst_local), _t(msgs), _t(valid),
                                   _t(lay.block_tile), lay.n_tiles,
                                   tile_v=256, block_e=512)
    assert got.shape == (n_windows, lay.n_tiles, 256, 3)
    for w in range(n_windows):
        np.testing.assert_allclose(as_np(got[w]),
                                   _jax_tiles(lay, dst_local, msgs[w], valid[w]), **TOL)
        # each window's row equals its own single-window call exactly
        one = tspmm.segment_spmm_tiles_plain(_t(dst_local), _t(msgs[w]), _t(valid[w]),
                                             _t(lay.block_tile), lay.n_tiles,
                                             tile_v=256, block_e=512)
        assert torch.equal(got[w], one)


def test_masked_lanes_contribute_nothing():
    """A NaN or inf message in a masked lane stays out of the sum, as does an
    out-of-range local id (the one-hot product ignores that one too; it
    would carry a masked NaN through 0 * NaN, which the port does not)."""
    lay, dst_local, msgs, valid = _layout_inputs(100, 700, 64, 128, 4, 0, 7)
    clean = tspmm.segment_spmm_tiles_plain(_t(dst_local), _t(msgs), _t(valid),
                                           _t(lay.block_tile), lay.n_tiles,
                                           tile_v=64, block_e=128)
    dirty = msgs.copy()
    dirty[valid == 0] = np.nan
    dirty[(valid == 0)[:, None] & (np.arange(4) == 1)] = np.inf
    got = tspmm.segment_spmm_tiles_plain(_t(dst_local), _t(dirty), _t(valid),
                                         _t(lay.block_tile), lay.n_tiles,
                                         tile_v=64, block_e=128)
    assert torch.equal(got, clean)
    d = dst_local.copy()
    d[::5] = 64
    d[1::7] = -1
    want = _jax_tiles(lay, d, msgs, valid)
    got = tspmm.segment_spmm_tiles_plain(_t(d), _t(msgs), _t(valid),
                                         _t(lay.block_tile), lay.n_tiles,
                                         tile_v=64, block_e=128)
    np.testing.assert_allclose(as_np(got), want, **TOL)


def _skewed_layout_inputs(dst, n_v, tile_v, block_e, seed):
    rng = np.random.default_rng(seed)
    lay = jops.prepare_layout(dst, n_v, tile_v=tile_v, block_e=block_e)
    lane = lay.perm >= 0
    seg = np.append(dst, 0)[np.where(lane, lay.perm, len(dst))]
    msgs = rng.random((lay.n_edges_padded, 2)).astype(np.float32)
    valid = (lane & (rng.random(lay.n_edges_padded) < 0.8)).astype(np.int32)
    return lay, (seg % tile_v).astype(np.int32), msgs, valid


@pytest.mark.parametrize("kind", ["one_slot", "empty_tiles"])
def test_segment_spmm_tiles_plain_matches_pallas_on_skewed_layouts(kind):
    """Every edge on one slot (one tile of many blocks, the kernel's shared
    flush), and edges in 3 of 12 tiles (tiles that own no block read 0)."""
    rng = np.random.default_rng(5)
    if kind == "one_slot":
        dst, n_v = np.full(3000, 37), 300
    else:
        ids = np.concatenate([np.arange(0, 64), np.arange(192, 256), np.arange(576, 640)])
        dst, n_v = rng.choice(ids, 2500), 768
    lay, dst_local, msgs, valid = _skewed_layout_inputs(dst, n_v, 64, 128, 6)
    want = _jax_tiles(lay, dst_local, msgs, valid)
    got = tspmm.segment_spmm_tiles(_t(dst_local), _t(msgs), _t(valid),
                                   _t(lay.block_tile), lay.n_tiles, tile_v=64, block_e=128)
    np.testing.assert_allclose(as_np(got), want, **TOL)
    owned = np.zeros(lay.n_tiles, bool)
    owned[lay.block_tile] = True
    assert (as_np(got)[~owned] == 0).all()
    if kind == "one_slot":
        assert lay.n_blocks == 24 and (lay.block_tile == 0).all()
        np.testing.assert_allclose(as_np(got)[0, 37], (msgs * valid[:, None]).sum(0),
                                   rtol=1e-6)
    else:
        assert owned.sum() == 3


def test_wrapper_rejects_unordered_block_tile():
    """The kernel needs a tile's blocks consecutive (block_tile
    nondecreasing, as the layout builds it); the wrapper checks it on the
    CPU."""
    lay, dst_local, msgs, valid = _layout_inputs(700, 6000, 256, 512, 1, 0, 3)
    bt = lay.block_tile.copy()
    assert (np.diff(bt) >= 0).all()
    bt[[0, -1]] = bt[[-1, 0]]
    with pytest.raises(ValueError, match="nondecreasing"):
        tspmm.segment_spmm_tiles(_t(dst_local), _t(msgs), _t(valid), _t(bt), lay.n_tiles,
                                 tile_v=256, block_e=512)


@pytest.mark.parametrize("n_windows,n_tiles,tile_v,d,want", [
    (1, 2227, 512, 1, (1140224, 2227)),     # power-law main path: one chunk
    (8, 2227, 512, 1, (9121792, 17816)),
    (1, 24, 128, 130, (399360, 72)),        # 48 columns of 128 slots: 3 chunks
    (3, 5, 64, 16, (15360, 15)),
])
def test_flush_scratch_sizes(n_windows, n_tiles, tile_v, d, want):
    assert tspmm.flush_scratch_sizes(n_windows, n_tiles, tile_v, d) == want


def test_wrapper_checks_inputs():
    lay, dst_local, msgs, valid = _layout_inputs(100, 700, 64, 128, 2, 0, 4)
    d, m, v, bt = _t(dst_local), _t(msgs), _t(valid), _t(lay.block_tile)
    kw = dict(tile_v=64, block_e=128)
    with pytest.raises(TypeError):
        tspmm.segment_spmm_tiles(d, m.double(), v, bt, lay.n_tiles, **kw)
    with pytest.raises(TypeError):
        tspmm.segment_spmm_tiles(d, m, v.bool(), bt, lay.n_tiles, **kw)
    with pytest.raises(ValueError):
        tspmm.segment_spmm_tiles(d, m[:-1], v[:-1], bt, lay.n_tiles, **kw)
    with pytest.raises(ValueError):
        tspmm.segment_spmm_tiles(d, m, v[None].expand(2, -1), bt, lay.n_tiles, **kw)
    with pytest.raises(ValueError):  # a strided view
        tspmm.segment_spmm_tiles(d, torch.cat([m, m], 1)[:, ::2], v, bt,
                                 lay.n_tiles, **kw)
    with pytest.raises(ValueError):  # no feature column
        tspmm.segment_spmm_tiles(d, m[:, :0], v, bt, lay.n_tiles, **kw)


@pytest.mark.parametrize("d", [16, 48, 128, 130])
def test_ops_spmm_sweep_matches_jax(d):
    """``ops.spmm`` on both sides, the sweep of ``tests/test_kernels.py``."""
    jg = jsynth(300, 2500, seed=d)
    tg = tsynth(300, 2500, seed=d, device=CPU)
    jl = jops.prepare_layout(np.asarray(jg.dst), 300, tile_v=128, block_e=256)
    tl = tops.prepare_layout(tg.dst, 300, tile_v=128, block_e=256)
    msgs = np.random.default_rng(d).standard_normal((2500, d)).astype(np.float32)
    want = np.asarray(jops.spmm(jl, jg.dst, jnp.asarray(msgs), n_vertices=300))
    got = tops.spmm(tl, tg.dst, _t(msgs), n_vertices=300)
    assert got.shape == (300, d)
    np.testing.assert_allclose(as_np(got), want, **TOL)
    ref = tref.segment_spmm_ref(tg.dst, _t(msgs), torch.ones(2500, dtype=torch.bool), 300)
    jr = jref.segment_spmm_ref(jg.dst, jnp.asarray(msgs), jnp.ones(2500, bool), 300)
    np.testing.assert_allclose(as_np(ref), np.asarray(jr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(as_np(got), as_np(ref), **TOL)


def test_ops_spmm_valid_mask_matches_jax():
    jg = jsynth(100, 900, seed=9)
    tg = tsynth(100, 900, seed=9, device=CPU)
    jl = jops.prepare_layout(np.asarray(jg.dst), 100, tile_v=64, block_e=128)
    tl = tops.prepare_layout(tg.dst, 100, tile_v=64, block_e=128)
    rng = np.random.default_rng(3)
    msgs = rng.standard_normal((900, 32)).astype(np.float32)
    valid = rng.random(900) < 0.4
    want = np.asarray(jops.spmm(jl, jg.dst, jnp.asarray(msgs), n_vertices=100,
                                valid_edges=jnp.asarray(valid)))
    got = tops.spmm(tl, tg.dst, _t(msgs), n_vertices=100, valid_edges=_t(valid))
    np.testing.assert_allclose(as_np(got), want, **TOL)
    ref = tref.segment_spmm_ref(tg.dst, _t(msgs), _t(valid), 100)
    np.testing.assert_allclose(as_np(got), as_np(ref), **TOL)


def _tiled_plans(n_v=300, n_e=5000, seed=2, tile_v=128, block_e=256):
    jg = jpower(n_v, n_e, seed=seed)
    tg = tpower(n_v, n_e, seed=seed, device=CPU)
    jl = jops.prepare_layout(np.asarray(jg.dst), n_v, tile_v, block_e)
    tl = tops.prepare_layout(tg.dst, n_v, tile_v, block_e)
    return (jg, tg, jplan.make_plan("scan", "pallas_tiled", layout=jl, n_edges=n_e),
            tplan.make_plan("scan", "pallas_tiled", layout=tl, n_edges=n_e))


@pytest.mark.parametrize("feature", [False, True])
def test_tiled_sum_combine_matches_pallas(feature):
    """The backend's sum branch, single and W=3 windows (one K3 call here, a
    ``lax.map`` of kernel calls there), [K] and [K, F] values."""
    jg, tg, jp, tp = _tiled_plans()
    rng = np.random.default_rng(int(feature))
    shape = (3, jg.n_edges, 5) if feature else (3, jg.n_edges)
    vals = rng.standard_normal(shape).astype(np.float32)
    masks = rng.random((3, jg.n_edges)) < 0.6
    backend = jback.PallasTiledBackend()
    want = np.asarray(backend._combine_sum_windows(
        jp, jnp.asarray(vals), jg.dst, jg.n_vertices, jnp.asarray(masks)))
    got = tback.combine_windows_for_plan(tp, _t(vals), tg.dst, tg.n_vertices, "sum",
                                         masks=_t(masks), use_layout=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(as_np(got), want, **TOL)
    seg = tback.segment_combine_windows(_t(vals), tg.dst, tg.n_vertices, "sum",
                                        masks=_t(masks))
    np.testing.assert_allclose(as_np(seg), want, **TOL)
    want1 = np.asarray(backend._combine_sum(jp, jnp.asarray(vals[0]), jg.dst,
                                            jg.n_vertices, None))
    got1 = tback.combine_for_plan(tp, _t(vals[0]), tg.dst, tg.n_vertices, "sum",
                                  use_layout=True)
    np.testing.assert_allclose(as_np(got1), want1, **TOL)
