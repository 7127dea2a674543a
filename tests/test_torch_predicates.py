"""The port's Allen-algebra ordering predicates
(``repro_torch.core.predicates``, paper §2.2): the mirrors of
``test_predicates.py`` on tensors, and every predicate equal to the JAX
package's on the same seeded intervals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.core import predicates as jpred
from repro_torch.core import predicates as tpred
from repro_torch.core.predicates import (
    OrderingPredicateType as T,
    edge_follows,
    in_window,
    interval_pair_satisfies,
)

interval = st.tuples(st.integers(0, 100), st.integers(0, 50)).map(
    lambda t: (t[0], t[0] + t[1])
)


def _t(*xs):
    return [torch.tensor(x) for x in xs]


@settings(max_examples=100, deadline=None)
@given(a=interval, b=interval)
def test_succeeds_definition(a, b):
    got = bool(interval_pair_satisfies(T.SUCCEEDS, *_t(a[0], a[1], b[0], b[1])))
    assert got == (a[1] <= b[0])


@settings(max_examples=100, deadline=None)
@given(a=interval, b=interval)
def test_strictly_succeeds_implies_succeeds(a, b):
    args = _t(a[0], a[1], b[0], b[1])
    strict = bool(interval_pair_satisfies(T.STRICTLY_SUCCEEDS, *args))
    weak = bool(interval_pair_satisfies(T.SUCCEEDS, *args))
    assert not strict or weak
    assert strict == (a[1] < b[0])


@settings(max_examples=100, deadline=None)
@given(a=interval, b=interval)
def test_overlaps_definition(a, b):
    got = bool(interval_pair_satisfies(T.OVERLAPS, *_t(a[0], a[1], b[0], b[1])))
    assert got == ((a[0] <= b[0]) and (a[1] <= b[1]))


def test_overlaps_requires_src_start():
    with pytest.raises(ValueError):
        edge_follows(T.OVERLAPS, 1, 2, 3)


@settings(max_examples=60, deadline=None)
@given(e=interval, w=interval)
def test_in_window(e, w):
    got = bool(in_window(*_t(e[0], e[1], w[0], w[1])))
    assert got == (e[0] >= w[0] and e[1] <= w[1])


def test_vectorized():
    ts = torch.tensor([1, 5, 9])
    te = torch.tensor([2, 6, 10])
    out = edge_follows(T.SUCCEEDS, torch.tensor([2, 6, 11]), ts, te)
    assert out.tolist() == [False, False, False]
    out = edge_follows(T.SUCCEEDS, torch.tensor([1, 5, 9]), ts, te)
    assert out.tolist() == [True, True, True]


@pytest.mark.parametrize("pred", list(T))
def test_predicates_equal_jax(pred):
    """Each predicate of the port on int32 tensors equals the reference's
    on the same 500 seeded interval pairs (and the enums agree)."""
    assert pred.value == jpred.OrderingPredicateType(pred.value).value
    jp = jpred.OrderingPredicateType(pred.value)
    rng = np.random.default_rng(len(pred.value))
    a0, b0 = rng.integers(0, 100, 500), rng.integers(0, 100, 500)
    a1, b1 = a0 + rng.integers(0, 50, 500), b0 + rng.integers(0, 50, 500)
    cols = [x.astype(np.int32) for x in (a0, a1, b0, b1)]
    want = jpred.interval_pair_satisfies(jp, *map(jnp.asarray, cols))
    got = interval_pair_satisfies(pred, *map(torch.as_tensor, cols))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        in_window(*map(torch.as_tensor, cols)).numpy(),
        np.asarray(jpred.in_window(*map(jnp.asarray, cols))))
    assert tpred.__all__ == jpred.__all__
