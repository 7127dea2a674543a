"""The comparisons that decide a run's ``correct``: the program's answers
against the plain reference's (``temporal.py``), as numbers that a cell's
limits hold.  Integer answers compare exactly (a count of entries that
differ); PageRank by its largest relative error."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.temporal import INF


def sparse_mismatch(got: torch.Tensor, verts: torch.Tensor, want: torch.Tensor,
                    fill: int = INF) -> int:
    """Entries of ``got`` [S, V] that differ from the reference, which
    holds ``want`` [S, n] on the vertices ``verts`` and ``fill`` on every
    other vertex."""
    got = got.reshape(-1, got.shape[-1])
    at = got[:, verts.to(got.device)].long()
    want = want.reshape(at.shape).to(got.device)
    off = int((at != want).sum())
    elsewhere = int((got != fill).sum()) - int((at != fill).sum())
    return off + elsewhere


def dense_mismatch(got, want) -> int:
    """Entries that differ between two whole answers (tensors or arrays)."""
    a = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    b = want.cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    return int((a.astype(np.int64) != b.astype(np.int64)).sum())


def max_rel_err(got, want) -> float:
    """max_v |got_v - want_v| / |want_v| (every PageRank entry is at least
    the teleport share, so no entry is 0)."""
    g = torch.as_tensor(got).double().to(want.device)
    w = want.double()
    return float(((g - w).abs() / w.abs()).max())


__all__ = ["sparse_mismatch", "dense_mismatch", "max_rel_err"]
