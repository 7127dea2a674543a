"""2D density histograms + summed-area tables for cardinality estimation.

Paper §5.2: at TGER-build time each indexed vertex gets a 2D density
histogram over (start_time, duration) with 100 buckets per dimension; at
query time it estimates how many edges satisfy the window, driving the
index-vs-scan decision.  Histograms are cumulated into summed-area tables
so a rectangle estimate is four bilinear samples.

Both the build and the estimate stay on the host.  The estimate runs in
float32, one operation at a time in the JAX package's order, so the
planner's decisions come out the same in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_BUCKETS = 100  # per dimension (paper §5.2)

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class Histogram2D:
    """SAT-cumulated (start, duration) histogram; possibly batched
    [..., nb+1, nb+1].  Host numpy arrays."""

    sat: np.ndarray          # f32[..., nb+1, nb+1]; sat[i,j] = #edges in bins [<i, <j]
    start_edges: np.ndarray  # f32[..., nb+1] bin boundaries (ascending)
    dur_edges: np.ndarray    # f32[..., nb+1]

    @property
    def n_buckets(self) -> int:
        return self.sat.shape[-1] - 1


def build_histogram(t_start, t_end, n_buckets: int = DEFAULT_BUCKETS) -> Histogram2D:
    """Host-side build of one (start × duration) SAT histogram."""
    t_start = np.asarray(t_start, dtype=np.float64)
    dur = np.asarray(t_end, dtype=np.float64) - t_start
    lo_s, hi_s = (t_start.min(), t_start.max()) if t_start.size else (0.0, 1.0)
    lo_d, hi_d = (dur.min(), dur.max()) if dur.size else (0.0, 1.0)
    hi_s = hi_s if hi_s > lo_s else lo_s + 1.0
    hi_d = hi_d if hi_d > lo_d else lo_d + 1.0
    start_edges = np.linspace(lo_s, hi_s, n_buckets + 1)
    dur_edges = np.linspace(lo_d, hi_d, n_buckets + 1)
    hist, _, _ = np.histogram2d(t_start, dur, bins=(start_edges, dur_edges))
    sat = np.zeros((n_buckets + 1, n_buckets + 1), dtype=np.float32)
    sat[1:, 1:] = hist.cumsum(axis=0).cumsum(axis=1)
    return Histogram2D(
        sat=sat,
        start_edges=start_edges.astype(np.float32),
        dur_edges=dur_edges.astype(np.float32),
    )


def stack_histograms(hists) -> Histogram2D:
    return Histogram2D(
        sat=np.stack([h.sat for h in hists]),
        start_edges=np.stack([h.start_edges for h in hists]),
        dur_edges=np.stack([h.dur_edges for h in hists]),
    )


def _frac_index(edges: np.ndarray, x: np.float32) -> np.float32:
    """Continuous bin coordinate of x in ``edges`` (linear within a bin)."""
    n = edges.shape[-1] - 1
    i = int(np.clip(np.searchsorted(edges, x, side="right") - 1, 0, n - 1))
    left, right = edges[i], edges[i + 1]
    frac = (x - left) / (right - left) if right > left else _F32(0.0)
    return np.clip(_F32(i) + frac, _F32(0.0), _F32(n))


def _sat_at(sat: np.ndarray, fi: np.float32, fj: np.float32) -> np.float32:
    """Bilinear sample of a 2-D SAT at fractional bin coords (fi, fj)."""
    n = sat.shape[-1] - 1
    i0 = min(max(int(np.floor(fi)), 0), n - 1)
    j0 = min(max(int(np.floor(fj)), 0), n - 1)
    di = fi - _F32(i0)
    dj = fj - _F32(j0)
    one = _F32(1)
    return (
        sat[i0, j0] * (one - di) * (one - dj)
        + sat[i0, j0 + 1] * (one - di) * dj
        + sat[i0 + 1, j0] * di * (one - dj)
        + sat[i0 + 1, j0 + 1] * di * dj
    )


def estimate_rect(hist: Histogram2D, start_lo, start_hi, dur_lo, dur_hi) -> np.float32:
    """Estimated #edges with start in [start_lo, start_hi] and duration in
    [dur_lo, dur_hi] (one unbatched histogram)."""
    fi_lo = _frac_index(hist.start_edges, _F32(start_lo))
    fi_hi = _frac_index(hist.start_edges, _F32(start_hi))
    fj_lo = _frac_index(hist.dur_edges, _F32(dur_lo))
    fj_hi = _frac_index(hist.dur_edges, _F32(dur_hi))
    est = (
        _sat_at(hist.sat, fi_hi, fj_hi)
        - _sat_at(hist.sat, fi_lo, fj_hi)
        - _sat_at(hist.sat, fi_hi, fj_lo)
        + _sat_at(hist.sat, fi_lo, fj_lo)
    )
    return max(est, _F32(0.0))


def estimate_window(hist: Histogram2D, window_start, window_end) -> np.float32:
    """Estimated #edges fully inside [window_start, window_end]: start in
    [ws, we], duration in [0, we - ws] (a conservative rectangle)."""
    ws = _F32(window_start)
    we = _F32(window_end)
    return estimate_rect(hist, ws, we, _F32(0.0), we - ws)


__all__ = [
    "Histogram2D",
    "build_histogram",
    "stack_histograms",
    "estimate_rect",
    "estimate_window",
    "DEFAULT_BUCKETS",
]
