"""The one-pass time-ordered EA baseline in the port against the JAX
package's ``earliest_arrival_onepass``, and against the frontier EA as
``test_algorithms.py::test_onepass_matches_frontier`` holds the JAX one.
Exact equality."""
import numpy as np
import pytest

import repro.core  # noqa: F401  (the JAX package must import core before engine)
import repro.core.predicates as jpred
import repro.data.generators as jgen
import repro_torch.core.predicates as tpred
import repro_torch.data.generators as tgen
from repro.core.onepass import earliest_arrival_onepass as j_onepass
from repro.core.tger import build_tger as jbuild
from repro_torch.core.algorithms import earliest_arrival
from repro_torch.core.onepass import earliest_arrival_onepass
from repro_torch.core.tger import build_tger as tbuild
from test_torch_common import as_np, assert_same, query_setup


@pytest.mark.parametrize("kind", ["power_law", "transit"])
@pytest.mark.parametrize("chunk_size", [64, 4096])
@pytest.mark.parametrize("intra_chunk_iters", [1, 2, 4])
def test_onepass_matches_jax(kind, chunk_size, intra_chunk_iters):
    jg, tg, ji, ti, wins, sources = query_setup(kind)
    for w in wins[:2]:
        want = j_onepass(jg, ji, sources[0], w, chunk_size=chunk_size,
                         intra_chunk_iters=intra_chunk_iters)
        got = earliest_arrival_onepass(tg, ti, sources[0], w, chunk_size=chunk_size,
                                       intra_chunk_iters=intra_chunk_iters)
        assert_same(want, got)


def test_onepass_strict_predicate_matches_jax():
    jg, tg, ji, ti, wins, sources = query_setup("transit")
    kw = dict(chunk_size=64, intra_chunk_iters=2)
    assert_same(
        j_onepass(jg, ji, sources[1], wins[0],
                  pred=jpred.OrderingPredicateType.STRICTLY_SUCCEEDS, **kw),
        earliest_arrival_onepass(tg, ti, sources[1], wins[0],
                                 pred=tpred.OrderingPredicateType.STRICTLY_SUCCEEDS, **kw))


def test_onepass_matches_frontier():
    """test_algorithms.py's case (seed 17): three relaxations per 64-edge
    chunk reach the frontier fixpoint."""
    g = tgen.synthetic_temporal_graph(50, 420, seed=17, device="cpu")
    jg = jgen.synthetic_temporal_graph(50, 420, seed=17)
    ts = as_np(g.t_start)
    win = (int(np.quantile(ts, 0.2)), int(as_np(g.t_end).max()))
    src = int(as_np(g.src)[17 % g.n_edges])
    idx = tbuild(g, degree_cutoff=16)
    got = earliest_arrival_onepass(g, idx, src, win, chunk_size=64, intra_chunk_iters=3)
    assert (as_np(got) == as_np(earliest_arrival(g, src, win))).all()
    assert_same(j_onepass(jg, jbuild(jg, degree_cutoff=16), src, win, chunk_size=64,
                          intra_chunk_iters=3), got)


def test_onepass_is_sound():
    """One relaxation per chunk may leave a label later than the fixpoint's,
    never earlier."""
    _, tg, _, ti, wins, sources = query_setup("transit")
    w, s = wins[0], sources[0]
    once = as_np(earliest_arrival_onepass(tg, ti, s, w, chunk_size=4096,
                                          intra_chunk_iters=1))
    assert (once >= as_np(earliest_arrival(tg, s, w, ti))).all()
