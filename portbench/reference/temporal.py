"""Plain reference of the temporal graph queries the benchmark's cells run.

Written from the queries' definitions (the paper's §2 and §4, and the
serving layer's documented semantics), in plain PyTorch and numpy.  It
imports nothing of the program, and nothing of the JAX package.  Every
function takes raw edge arrays that the benchmark generated itself and a
window ``(ta, tb)``: an edge is in the window when ``ta <= t_start`` and
``t_end <= tb``.

* Earliest arrival (EA): the source holds ``ta``; an edge (u, v, s, e) in
  the window extends a path that reached u at ``a`` when ``a <= s`` (the
  ``succeeds`` ordering: the path ends before the edge starts, ties
  allowed), and reaches v at ``e``.  Bellman-Ford rounds until nothing
  improves.
* Minimum-hop BFS: the same rounds; a vertex's hop count is the first
  round in which it becomes reachable (the source: 0).
* Connected components: weak components of the window's edges (scipy),
  each vertex labelled with the least vertex id of its component.
* PageRank: power iteration from the uniform vector with damping ``d``;
  out-degrees count the window's edges; with ``dangling=True`` the mass
  of vertices without out-edges in the window is spread uniformly.

``time_dtype`` / ``dtype`` / ``acc_dtype`` lower the arithmetic for the
controls (a reference computed in a lower precision than the
configuration states); ``strict=True`` breaks the ``succeeds`` tie rule.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

INF = 2**31 - 1   # "never" on the int32 time axis


def in_window(ts, te, window):
    """Mask of the edges that lie inside ``window``."""
    ta, tb = int(window[0]), int(window[1])
    return (ts >= ta) & (te <= tb)


def window_edges(src, dst, ts, te, window):
    """The edges (numpy or tensors) that lie inside ``window``."""
    m = in_window(ts, te, window)
    return src[m], dst[m], ts[m], te[m]


def _as_long(a, device):
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                           device=device).long()


def _relabel(s, d, sources, device):
    """Compact vertex ids: ``verts`` (sorted, i64) holds every endpoint and
    source; returns it with the compact source, destination and source-row
    ids."""
    s, d = _as_long(s, device), _as_long(d, device)
    srcs = _as_long(sources, device).reshape(-1)
    verts = torch.unique(torch.cat([s, d, srcs]))
    return (verts, torch.searchsorted(verts, s), torch.searchsorted(verts, d),
            torch.searchsorted(verts, srcs))


def bellman_ford(src, dst, ts, te, sources, window, *, device="cpu", strict=False,
                 time_dtype=torch.int64, hops: bool = False):
    """EA (and with ``hops=True`` minimum-hop counts) from each source over
    the window's edges.  Returns ``(verts, arrival[S, n])`` (and
    ``hops[S, n]``) on the compact vertex ids ``verts``; entries not
    reached hold ``INF``.  ``time_dtype`` sets the type the times are held
    and compared in (a float type for a control)."""
    s, d, t1, t2 = window_edges(src, dst, ts, te, window)
    verts, si, di, qi = _relabel(s, d, sources, device)
    floating = time_dtype.is_floating_point
    never = float("inf") if floating else INF
    t1 = torch.as_tensor(np.asarray(t1) if not isinstance(t1, torch.Tensor) else t1,
                         device=device).to(time_dtype)
    t2 = torch.as_tensor(np.asarray(t2) if not isinstance(t2, torch.Tensor) else t2,
                         device=device).to(time_dtype)
    S, n = qi.shape[0], verts.shape[0]
    rows = torch.arange(S, device=device)
    arr = torch.full((S, n), never, dtype=time_dtype, device=device)
    arr[rows, qi] = torch.tensor(int(window[0]), device=device).to(time_dtype)
    hop = torch.full((S, n), INF, dtype=torch.int64, device=device)
    hop[rows, qi] = 0
    idx = di[None, :].expand(S, -1)
    rnd = 0
    while True:
        rnd += 1
        a = arr[:, si]
        ok = ((a < t1) if strict else (a <= t1)) & (a < never)
        cand = torch.where(ok, t2[None, :], torch.tensor(never, dtype=time_dtype,
                                                         device=device))
        new = arr.scatter_reduce(1, idx, cand, "amin", include_self=True)
        if hops:
            hop = torch.where((new < never) & (hop == INF), rnd, hop)
        if torch.equal(new, arr):
            break
        arr = new
    if floating:   # back onto the int32 axis the program answers on (INF itself
        # would round to 2**31 in float32: it is put back as an integer)
        arr = torch.where(arr < never, arr.round().to(torch.int64),
                          torch.full(arr.shape, INF, dtype=torch.int64, device=device))
    return (verts, arr, hop) if hops else (verts, arr)


def connected_components(src, dst, ts, te, n_vertices: int, window) -> np.ndarray:
    """Least vertex id of each vertex's weak component over the window's
    edges (an isolated vertex is its own component): i64[V], numpy."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as components

    s, d, _, _ = window_edges(*(np.asarray(a) for a in (src, dst, ts, te)), window)
    adj = coo_matrix((np.ones(len(s), np.int8), (s, d)), shape=(n_vertices, n_vertices))
    _, comp = components(adj, directed=True, connection="weak")
    least = np.full(comp.max() + 1, n_vertices, np.int64)
    np.minimum.at(least, comp, np.arange(n_vertices))
    return least[comp]


def pagerank_chunks(chunks: Callable[[], Iterable[Tuple]], n_vertices: int, window,
                    n_iters: int, *, damping: float = 0.85, dangling: bool = True,
                    device="cpu", dtype=torch.float64, acc_dtype: Optional[torch.dtype] = None):
    """PageRank over the window's edges, streamed by ``chunks()`` (a
    callable yielding (src, dst, ts, te) tensors, called once per pass).
    ``dtype`` holds the rank vector and contributions, ``acc_dtype``
    (default ``dtype``) the per-vertex sums.  Returns pr[V] in ``dtype``."""
    acc = acc_dtype or dtype
    V = n_vertices
    deg = torch.zeros(V, dtype=torch.int64, device=device)
    for s, _, ts, te in chunks():
        m = in_window(ts, te, window)
        deg += torch.bincount(s[m].long(), minlength=V)
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1).to(torch.float64), 0.0).to(dtype)
    sink = deg == 0
    pr = torch.full((V,), 1.0 / V, dtype=torch.float64, device=device).to(dtype)
    for _ in range(n_iters):
        agg = torch.zeros(V, dtype=acc, device=device)
        for s, d, ts, te in chunks():
            m = in_window(ts, te, window)
            sl = s[m].long()
            agg.index_add_(0, d[m].long(), (pr[sl] * inv[sl]).to(acc))
        total = agg.to(dtype)
        if dangling:
            total = total + pr[sink].to(acc).sum().to(dtype) / V
        pr = (1.0 - damping) / V + damping * total
    return pr


def pagerank(src, dst, ts, te, n_vertices: int, window, n_iters: int, **kw):
    """:func:`pagerank_chunks` over one in-memory edge list."""
    device = kw.get("device", "cpu")
    arrays = tuple(_as_long(a, device) for a in (src, dst, ts, te))
    return pagerank_chunks(lambda: [arrays], n_vertices, window, n_iters, **kw)


__all__ = ["INF", "in_window", "window_edges", "bellman_ford", "connected_components",
           "pagerank_chunks", "pagerank"]
