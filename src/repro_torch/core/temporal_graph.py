"""Temporal graph data model (paper §2.1) and T-CSR storage (paper §4.2).

A temporal graph G = (V, E, T, tau[, w]): each directed edge carries a
discrete validity interval [t_start, t_end] and an optional weight.

Storage is the paper's T-CSR: CSR arrays extended with parallel
``t_start`` / ``t_end`` arrays, edges sorted by ``(src, t_start)``.  The
in-edge view is a permutation into the same storage.  The sort runs on the
host in numpy; only the finished arrays go to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, to_numpy

INF_TIME = 2**31 - 1  # int32 max: "never" on the int32 time axis


@dataclasses.dataclass(frozen=True)
class TemporalGraph:
    """T-CSR temporal graph; every tensor lies on one device.

    Edge tensors are sorted by (src, t_start); ``out_offsets[v]`` is the
    first edge of vertex ``v``.  ``in_perm`` permutes edge ids into
    (dst, t_start) order with ``in_offsets`` the matching offsets.
    """

    src: torch.Tensor          # i32[E]
    dst: torch.Tensor          # i32[E]
    t_start: torch.Tensor      # i32[E]
    t_end: torch.Tensor        # i32[E]
    weight: torch.Tensor       # f32[E]
    out_offsets: torch.Tensor  # i32[V+1]
    in_perm: torch.Tensor      # i32[E]
    in_offsets: torch.Tensor   # i32[V+1]
    n_vertices: int
    n_edges: int

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def out_degree(self) -> torch.Tensor:
        return self.out_offsets[1:] - self.out_offsets[:-1]

    @property
    def in_degree(self) -> torch.Tensor:
        return self.in_offsets[1:] - self.in_offsets[:-1]

    def in_edge_fields(self):
        """Edge tensors gathered into (dst, t_start) order."""
        p = self.in_perm.long()
        return self.dst[p], self.src[p], self.t_start[p], self.t_end[p], self.weight[p]


def _build_offsets(sorted_keys: np.ndarray, n_vertices: int) -> np.ndarray:
    counts = np.bincount(sorted_keys, minlength=n_vertices)
    offsets = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets.astype(np.int32)


def from_edges(
    src,
    dst,
    t_start,
    t_end=None,
    weight=None,
    n_vertices: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    *,
    device=None,
) -> TemporalGraph:
    """Build a T-CSR TemporalGraph from raw edge arrays (numpy or tensors).

    If ``t_end`` is missing it is sampled uniformly in
    [t_start, t_start + span // 10], as the paper does for datasets with
    start times only (§6 Datasets).
    """
    dev = resolve_device(device)
    src = np.asarray(to_numpy(src), dtype=np.int64)
    dst = np.asarray(to_numpy(dst), dtype=np.int64)
    t_start = np.asarray(to_numpy(t_start), dtype=np.int64)
    n_e = src.shape[0]
    if n_vertices is None:
        n_vertices = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if t_end is None:
        rng = rng or np.random.default_rng(0)
        span = max(int(t_start.max(initial=1) - t_start.min(initial=0)), 1)
        dur = rng.integers(0, max(span // 10, 1) + 1, size=n_e)
        t_end = t_start + dur
    t_end = np.asarray(to_numpy(t_end), dtype=np.int64)
    if weight is None:
        weight = np.ones(n_e, dtype=np.float32)
    weight = np.asarray(to_numpy(weight), dtype=np.float32)

    # sort by (src, t_start): every per-vertex adjacency slice is then
    # start-time-sorted (the per-vertex TGER entry point).
    order = np.lexsort((t_start, src))
    src, dst, t_start, t_end, weight = (
        a[order] for a in (src, dst, t_start, t_end, weight)
    )
    out_offsets = _build_offsets(src, n_vertices)

    # in-edge permutation: edge ids in (dst, t_start) order.
    in_perm = np.lexsort((t_start, dst)).astype(np.int32)
    in_offsets = _build_offsets(dst[in_perm], n_vertices)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)

    return TemporalGraph(
        src=i32(src),
        dst=i32(dst),
        t_start=i32(t_start),
        t_end=i32(t_end),
        weight=torch.as_tensor(weight, device=dev),
        out_offsets=i32(out_offsets),
        in_perm=i32(in_perm),
        in_offsets=i32(in_offsets),
        n_vertices=int(n_vertices),
        n_edges=int(n_e),
    )


def validate(g: TemporalGraph) -> None:
    """Cheap structural invariants; raises ``ValueError`` on a breach."""
    if not (g.src.shape == g.dst.shape == g.t_start.shape == g.t_end.shape):
        raise ValueError("edge tensors must share one shape")
    if int(g.out_offsets[-1]) != g.n_edges or int(g.in_offsets[-1]) != g.n_edges:
        raise ValueError("offsets must end at n_edges")
    s = to_numpy(g.src)
    if not (np.diff(s) >= 0).all():
        raise ValueError("T-CSR must be src-sorted")
    ts = to_numpy(g.t_start)
    off = to_numpy(g.out_offsets)
    for v in range(min(g.n_vertices, 64)):  # spot-check slices
        if not (np.diff(ts[off[v]: off[v + 1]]) >= 0).all():
            raise ValueError("per-vertex slice must be start-sorted")
    if not bool((g.t_end >= g.t_start).all()):
        raise ValueError("intervals must be well-formed")


__all__ = ["TemporalGraph", "from_edges", "validate"]
