"""The window sweep for all seven algorithms of the JAX package's sweep:
``sweep`` and ``sweep_looped`` in the port against the JAX ``sweep``, and
against each other.  Integer outputs exactly; PageRank and betweenness
within rtol 1e-5 / atol 1e-7 of JAX (a float sum), and exactly between
the port's own batched and looped runs where their edge sets coincide."""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.serve.window_sweep as jsweep
import repro_torch.serve.window_sweep as tsweep
from test_torch_common import as_np, assert_same, query_setup

FLOAT = {"pagerank", "betweenness"}
KWARGS = {"kcore": dict(k=3), "pagerank": dict(n_iters=15),
          "betweenness": dict(n_buckets=32)}


def _windows(jg):
    t_hi = int(np.asarray(jg.t_end).max())
    span = t_hi - int(np.asarray(jg.t_start).min())
    return tsweep.sliding_windows(t_hi, width=span // 4, stride=span // 12, count=4)


@pytest.mark.parametrize("access,backend", [("scan", "pallas_tiled"),
                                            ("scan", "xla_segment"),
                                            ("index", "xla_segment")])
@pytest.mark.parametrize("algorithm", tsweep.ALGORITHMS)
def test_sweep_matches_jax_and_looped(algorithm, access, backend):
    jg, tg, ji, ti, _, sources = query_setup("power_law")
    windows = _windows(jg)
    kw = KWARGS.get(algorithm, {})
    s = sources[0]
    want = jsweep.sweep(jg, s, windows, ji, algorithm=algorithm, access=access,
                        backend=backend, **kw)
    got = tsweep.sweep(tg, s, windows, ti, algorithm=algorithm, access=access,
                       backend=backend, **kw)
    looped = tsweep.sweep_looped(tg, s, windows, ti, algorithm=algorithm,
                                 access=access, backend=backend, **kw)
    if algorithm in FLOAT:
        assert as_np(got).shape == (len(windows), tg.n_vertices)
        np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=1e-5, atol=1e-7)
        if access == "scan":  # the looped rows see the same edge order
            assert torch.equal(got, looped)
        else:
            np.testing.assert_allclose(as_np(looped), as_np(got), rtol=1e-5, atol=1e-7)
    else:
        assert_same(want, got)
        assert_same(want, looped)


def test_sweep_kcore_requires_k_and_rejects_unknown():
    _, tg, _, ti, wins, _ = query_setup("transit")
    for fn in (tsweep.sweep, tsweep.sweep_looped):
        with pytest.raises(ValueError, match="k= parameter"):
            fn(tg, 0, [wins[0]], ti, algorithm="kcore")
        with pytest.raises(ValueError, match="algorithm must be one of"):
            fn(tg, 0, [wins[0]], ti, algorithm="pagerank2")
