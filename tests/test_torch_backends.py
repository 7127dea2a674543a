"""The port's backend objects (``repro_torch.engine.get_backend``,
``XlaSegmentBackend``, ``PallasTiledBackend``) against the JAX package's:
the segment path's combines equal ``repro``'s ``XlaSegmentBackend`` on the
same inputs (integers bit for bit, float32 sums within rtol 1e-6: the port
adds in float64 and rounds once), single-window and batched, and the
registry answers and refuses the same names."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.engine import backends as jbk
from repro_torch.engine import (
    ExecutionBackend,
    PallasTiledBackend,
    XlaSegmentBackend,
    get_backend,
)
from repro_torch.engine.backends import segments_for


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("op,dtype", [("min", np.int32), ("max", np.int32),
                                      ("sum", np.int32), ("sum", np.float32)])
def test_xla_segment_backend_matches_jax(op, dtype, masked):
    rng = np.random.default_rng(7)
    K, N, W = 400, 37, 3
    ids = rng.integers(0, N, K).astype(np.int32)
    vals = (rng.integers(-1000, 1000, (W, K)) if dtype == np.int32
            else rng.standard_normal((W, K))).astype(dtype)
    masks = rng.random((W, K)) < 0.6 if masked else None
    jb, tb = jbk.get_backend("xla_segment"), get_backend("xla_segment")
    assert isinstance(tb, XlaSegmentBackend) and tb.name == jb.name
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == np.float32 else dict(rtol=0, atol=0)
    for tids in (torch.as_tensor(ids), segments_for(None, torch.as_tensor(ids))):
        want = jb.combine(None, jnp.asarray(vals[0]), jnp.asarray(ids), N, op,
                          mask=None if masks is None else jnp.asarray(masks[0]))
        got = tb.combine(None, torch.as_tensor(vals[0]), tids, N, op,
                         mask=None if masks is None else torch.as_tensor(masks[0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
        assert got.numpy().dtype == np.asarray(want).dtype
        want = jb.combine_windows(None, jnp.asarray(vals), jnp.asarray(ids), N, op,
                                  masks=None if masks is None else jnp.asarray(masks))
        got = tb.combine_windows(None, torch.as_tensor(vals), tids, N, op,
                                 masks=None if masks is None else torch.as_tensor(masks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_backend_registry_matches_jax():
    for name in ("xla_segment", "pallas_tiled"):
        assert get_backend(name).name == jbk.get_backend(name).name == name
        assert all(callable(getattr(get_backend(name), m, None))
                   for m in ExecutionBackend.__dict__ if m.startswith("combine"))
    assert isinstance(get_backend("pallas_tiled"), PallasTiledBackend)
    for fn in (get_backend, jbk.get_backend):
        with pytest.raises(ValueError, match="unknown backend"):
            fn("nope")
