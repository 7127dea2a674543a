"""The port's bounded-LRU ``identity_cache`` (``repro_torch/core/hostcache.py``),
mirroring ``test_hostcache.py``: hard-capped, least-recently-used eviction,
evicted entries recompute correctly, value keys participate and a recycled
``id()`` never serves a stale entry.  Torch tensors are keyed by identity
like numpy arrays (the last test)."""
import numpy as np
import torch

from repro_torch.core.hostcache import identity_cache


def _counted(max_entries):
    calls = []

    @identity_cache(max_entries)
    def fn(arr, scale):
        calls.append((id(arr), scale))
        return np.asarray(arr) * scale

    return fn, calls


def test_hit_returns_cached_value_without_recompute():
    fn, calls = _counted(4)
    a = np.arange(5)
    r1 = fn(a, 2)
    r2 = fn(a, 2)
    assert r1 is r2 and len(calls) == 1
    assert (r1 == a * 2).all()


def test_capacity_is_a_hard_cap():
    fn, calls = _counted(3)
    arrays = [np.arange(4) + i for i in range(10)]
    for a in arrays:
        fn(a, 1)
    assert len(fn.cache) <= fn.max_entries == 3


def test_eviction_recomputes_correctly():
    """An evicted entry recomputes and the value is still right — eviction
    can cost time, never correctness."""
    fn, calls = _counted(2)
    a, b, c = np.arange(3), np.arange(3) + 10, np.arange(3) + 20
    fn(a, 3)
    fn(b, 3)
    fn(c, 3)            # evicts a (capacity 2)
    n_before = len(calls)
    out = fn(a, 3)      # recompute, not a stale hit
    assert len(calls) == n_before + 1
    assert (out == a * 3).all()


def test_lru_keeps_the_hot_entry_resident():
    """FIFO would evict the OLDEST insertion even if it is read every call;
    LRU must keep it.  This is the long-horizon serving pattern: one graph's
    artifact re-read per advance while window-keyed entries churn."""
    fn, calls = _counted(2)
    hot, cold1, cold2 = np.arange(6), np.arange(6) + 1, np.arange(6) + 2
    fn(hot, 1)
    fn(cold1, 1)        # cache: [hot, cold1]
    fn(hot, 1)          # LRU touch: hot is now most recent
    fn(cold2, 1)        # must evict cold1, NOT hot
    n_before = len(calls)
    fn(hot, 1)
    assert len(calls) == n_before, "the hot entry was evicted by churn"
    fn(cold1, 1)
    assert len(calls) == n_before + 1, "cold1 should have been the evictee"


def test_value_keys_participate():
    fn, calls = _counted(8)
    a = np.arange(4)
    r2 = fn(a, 2)
    r3 = fn(a, 3)
    assert len(calls) == 2
    assert (r2 == a * 2).all() and (r3 == a * 3).all()


def test_recycled_id_never_serves_a_stale_entry():
    """The identity pin: if a keyed array dies and a NEW array reuses its
    id(), the stale entry must not be served (the pinned ref comparison
    fails) and the stale slot is dropped."""

    @identity_cache(4)
    def fn(arr):
        return float(np.sum(arr))

    a = np.arange(10, dtype=np.float64)
    v1 = fn(a)
    key = next(iter(fn.cache))
    # simulate id reuse: swap the pinned ref for a DIFFERENT array under
    # the same key (deterministic stand-in for gc + allocator reuse)
    impostor = np.arange(10, dtype=np.float64) + 5
    fn.cache[key] = ((impostor,), v1)
    out = fn(a)
    assert out == float(np.sum(a))


def test_window_churn_stays_bounded_under_long_horizon():
    """The multi-tenant regression shape: one pinned array, thousands of
    distinct window-value keys.  Memory (entry count) stays capped and the
    answers stay correct throughout."""
    fn, _ = _counted(8)
    base = np.arange(16)
    for step in range(2000):
        out = fn(base, step % 37)
        assert (out == base * (step % 37)).all()
        assert len(fn.cache) <= 8


def test_tensor_arguments_keyed_by_identity():
    """A torch tensor is an array argument: keyed by identity and pinned,
    so an equal but distinct tensor recomputes."""
    fn, calls = _counted(4)
    a = torch.arange(5)
    assert fn(a, 2) is fn(a, 2) and len(calls) == 1
    fn(torch.arange(5), 2)
    assert len(calls) == 2 and len(fn.cache) == 2
