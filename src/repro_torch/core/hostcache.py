"""Identity-keyed host-side caches for artifacts derived from immutable
tensors (host copies of the time-first order, the per-vertex budget keys,
the tile layout).

The discipline: key on ``id()`` of the array arguments (value for the
rest), pin a strong reference to each keyed array and re-check it with
``is`` on every hit so a recycled ``id()`` never aliases a stale entry, and
evict least-recently-used entries past a hard cap.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np


def _is_array(a) -> bool:
    return isinstance(a, np.ndarray) or hasattr(a, "__array__") and hasattr(
        a, "dtype")


def identity_cache(max_entries: int = 16) -> Callable:
    """Decorator: memoize ``fn(*args)`` keyed by the identity of its array
    arguments (value for non-arrays), strong-ref-pinned, LRU-bounded at
    ``max_entries``."""

    def deco(fn):
        cache: dict = {}

        @functools.wraps(fn)
        def wrapped(*args):
            key = tuple(id(a) if _is_array(a) else a for a in args)
            hit = cache.get(key)
            if hit is not None and all(
                (p is a) for p, a in zip(hit[0], args) if p is not None
            ):
                del cache[key]  # LRU touch: move to the back
                cache[key] = hit
                return hit[1]
            if hit is not None:
                del cache[key]  # id() reused by a new array: stale entry
            value = fn(*args)
            while len(cache) >= max_entries:
                cache.pop(next(iter(cache)))
            pins = tuple(a if _is_array(a) else None for a in args)
            cache[key] = (pins, value)
            return value

        wrapped.cache = cache  # introspection for tests
        wrapped.max_entries = max_entries
        return wrapped

    return deco


__all__ = ["identity_cache"]
