"""One-pass time-ordered baseline (TeGraph-style, cf. paper §6.4).

Wu et al. process edges in ascending start-time order exactly once;
TeGraph's "OnePass" baseline does the same.  Here the TGER time-first
order is cut into fixed-size chunks and each chunk applies
``intra_chunk_iters`` parallel relaxations.  One pass suffices for
earliest arrival because an edge is enabled only by edges that start
earlier, which live in earlier chunks, up to chains inside one chunk
(``intra_chunk_iters``).  The chunk loop is a host loop; nothing in it
syncs with the host.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.edgemap import INT_INF
from repro_torch.core.predicates import OrderingPredicateType, edge_follows, in_window
from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex


def earliest_arrival_onepass(
    g: TemporalGraph,
    tger: TGERIndex,
    source,
    window: Tuple[int, int],
    *,
    pred: OrderingPredicateType = OrderingPredicateType.SUCCEEDS,
    chunk_size: int = 4096,
    intra_chunk_iters: int = 2,
) -> torch.Tensor:
    """EA by a single time-ordered sweep: O(E) work whatever the window's
    selectivity, the comparison point selective indexing beats.  A chain of
    more than ``intra_chunk_iters`` edges inside one chunk can leave a label
    later than the fixpoint's (never earlier)."""
    ta, tb = int(window[0]), int(window[1])
    arrival = torch.full((g.n_vertices,), INT_INF, dtype=torch.int32, device=g.device)
    arrival[torch.as_tensor(source, device=g.device).long()] = ta
    order = tger.perm_by_start.long()
    src, dst = g.src[order].long(), g.dst[order].long()
    ts, te = g.t_start[order], g.t_end[order]
    valid = in_window(ts, te, ta, tb)
    for lo in range(0, g.n_edges, chunk_size):
        c = slice(lo, lo + chunk_size)
        s_c, d_c, ts_c, te_c, v_c = src[c], dst[c], ts[c], te[c], valid[c]
        for _ in range(intra_chunk_iters):
            # the sources' labels are read before the chunk's writes, as in
            # one parallel relaxation; min-into-place equals min(arr, upd)
            ok = v_c & edge_follows(pred, arrival[s_c], ts_c, te_c)
            arrival.scatter_reduce_(0, d_c, torch.where(ok, te_c, INT_INF), "amin")
    return arrival


__all__ = ["earliest_arrival_onepass"]
