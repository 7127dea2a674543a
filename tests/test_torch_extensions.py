"""The port's overlaps reachability (``repro_torch.core.algorithms.
reachability.overlaps_reachability``): the mirrors of
``test_extensions.py``'s three overlaps tests, held to the reference's
numpy oracle (``repro/core/reference.py``) and to the JAX package's result
on the same graph (bit for bit)."""
import numpy as np
from hypothesis import given, settings, strategies as st

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.core import reference as R
from repro.core.algorithms.reachability import overlaps_reachability as joverlaps
from repro_torch.core.algorithms.reachability import overlaps_reachability
from test_torch_common import as_np, assert_same, both_graphs


def test_overlaps_simple_chain():
    # (0->1, [1,5]) overlaps (1->2, [2,6]): 1<=2 and 5<=6 -> reachable
    # (1->3, [0,9]): start 0 < 1 -> NOT a valid overlaps continuation
    jg, g = both_graphs([0, 1, 1], [1, 2, 3], [1, 2, 0], [5, 6, 9], n_vertices=4)
    reach, ls, le = overlaps_reachability(g, 0, (0, 10))
    assert bool(reach[2])
    assert not bool(reach[3])
    assert int(ls[2]) == 2 and int(le[2]) == 6
    assert_same(joverlaps(jg, 0, (0, 10)), (reach, ls, le))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 400))
def test_overlaps_soundness_property(seed):
    """Everything reported reachable is reachable per the exhaustive Pareto
    oracle, and the port equals the reference."""
    from repro.core.temporal_graph import from_edges as jfrom_edges
    from repro_torch.core.temporal_graph import from_edges

    rng = np.random.default_rng(seed)
    n_v, n_e = 20, 120
    cols = (rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e), rng.integers(0, 50, n_e))
    # from_edges draws the durations from ``rng`` when t_end is None: give
    # each package the same fresh generator
    jg = jfrom_edges(*cols, None, n_vertices=n_v, rng=np.random.default_rng(seed))
    g = from_edges(*cols, None, n_vertices=n_v, rng=np.random.default_rng(seed),
                   device="cpu")
    src = int(rng.integers(0, n_v))
    got = overlaps_reachability(g, src, (0, 10_000))
    oracle = R.overlaps_reachability_ref(g, src, (0, 10_000))
    reach = as_np(got[0])
    assert (reach <= oracle).all(), "reported-reachable must be truly reachable"
    assert reach[src]
    assert_same(joverlaps(jg, src, (0, 10_000)), got)


def test_overlaps_exact_on_nested_intervals():
    """Similarly-ordered starts/ends: lex-min heuristic is complete."""
    rng = np.random.default_rng(3)
    n_v, n_e = 25, 200
    ts = np.sort(rng.integers(0, 100, n_e))
    te = ts + 5  # constant duration: starts and ends co-ordered
    jg, g = both_graphs(rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e),
                        ts, te, n_vertices=n_v)
    src = int(g.src[0])
    got = overlaps_reachability(g, src, (0, 1000))
    oracle = R.overlaps_reachability_ref(g, src, (0, 1000))
    assert (as_np(got[0]) == oracle).all()
    assert_same(joverlaps(jg, src, (0, 1000)), got)
