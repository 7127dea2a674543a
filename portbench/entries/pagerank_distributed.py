"""Request kind ``pagerank_distributed``: temporal PageRank "as of" a time
``t_q`` over the window ``[t_lo, t_q]`` (``t_lo`` the first start), through
the distributed engine on the one-rank mesh: the window's out-degree by
the port's ``segment_combine`` over the edge chunks, then ``iterations``
rounds of ``make_pagerank_round`` (damping ``damping``) from the uniform
vector.  ``t_q`` is drawn uniformly in the upper half of the time range,
one for each of ``queries`` queries; set-up counts the edges inside each
window from its own draw, for the combine roofline.  The check draws the
edges again from the seed and recomputes each sampled query in float64."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import compare, temporal

UNIT = "query"


class Requests(NamedTuple):
    windows: np.ndarray   # i64[Q, 2]
    inside: np.ndarray    # i64[Q]: edges that lie inside each window


def draw(traffic: dict, config: dict, edges, seed: int, device) -> Requests:
    t_lo, t_hi = int(edges.t_sorted[0]), int(edges.te.max())
    rng = np.random.default_rng([seed, 1])
    t_q = rng.integers((t_lo + t_hi) // 2, t_hi + 1, size=traffic["queries"])
    # every edge starts at or after t_lo, so an edge lies inside [t_lo, t_q]
    # when it ends by t_q: count the ends at or below each t_q in one pass
    order = np.argsort(t_q, kind="stable")
    bounds = torch.as_tensor(t_q[order], dtype=edges.te.dtype, device=edges.te.device)
    hist = torch.zeros(len(t_q) + 1, dtype=torch.int64, device=edges.te.device)
    for lo in range(0, edges.n_edges, 1 << 27):
        te = edges.te[lo:lo + (1 << 27)]
        hist += torch.bincount(torch.bucketize(te, bounds), minlength=len(t_q) + 1)
    inside = np.empty(len(t_q), dtype=np.int64)
    inside[order] = hist.cumsum(0)[:-1].cpu().numpy()
    return Requests(np.stack([np.full_like(t_q, t_lo), t_q], axis=1), inside)


class Driver:
    def __init__(self, system, req: Requests, traffic: dict, config: dict, device):
        from repro_torch.distributed import graph_engine as ge

        self.sys, self.req, self.traffic, self.device = system, req, traffic, device
        self.pr_round = ge.make_pagerank_round(system.mesh, system.n_vertices,
                                               damping=traffic["damping"])
        self.chunk = ge.EDGE_CHUNK

    def query(self, q: int):
        from repro_torch.engine import backends

        ta, tb = (int(x) for x in self.req.windows[q])
        src, dst, ts, te = self.sys.edges
        valid, V = self.sys.valid, self.sys.n_vertices
        deg = None
        for lo in range(0, src.shape[0], self.chunk):
            sl = slice(lo, lo + self.chunk)
            ok = valid[sl] & (ts[sl] >= ta) & (te[sl] <= tb)
            part = backends.segment_combine(ok.to(torch.int32), src[sl], V, "sum")
            deg = part if deg is None else deg.add_(part)
        inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1).float(),
                          torch.zeros((), device=self.device))
        pr = torch.full((V,), 1.0 / V, dtype=torch.float32, device=self.device)
        for _ in range(self.traffic["iterations"]):
            pr = self.pr_round(pr, src, dst, ts, te, valid, inv, (ta, tb))
        return pr

    def warm(self):
        for q in range(self.traffic["warm_queries"]):
            self.query(len(self.req.windows) - 1 - q)

    def request(self, i: int):
        q = i % len(self.req.windows)
        it, inside = self.traffic["iterations"], int(self.req.inside[q])
        return (q, self.query(q)), {"queries": 1, "iterations": it,
                                    "window_edges": inside, "window_edge_iterations": it * inside,
                                    "vertices": self.sys.n_vertices}

    def release(self):
        self.sys = self.pr_round = None


def check(ctx, samples, control=None) -> dict:
    """Each sampled query's ranks against the float64 reference: the
    largest relative error; with ``control`` the reference with its sums
    in the configuration's lower precision stands in for the program."""
    lowp = ctx.config["control"] if control else None
    edges = ctx.builder.generate(ctx.config, ctx.seed, ctx.device, with_order=False)
    t = ctx.traffic
    err = 0.0
    for _, (q, pr) in samples:
        window = tuple(int(x) for x in ctx.requests.windows[q])
        kw = dict(damping=t["damping"], dangling=False, device=ctx.device)
        want = temporal.pagerank_chunks(edges.chunks, edges.n_vertices, window,
                                        t["iterations"], **kw)
        if lowp:
            pr = temporal.pagerank_chunks(edges.chunks, edges.n_vertices, window,
                                          t["iterations"],
                                          dtype=getattr(torch, lowp["rank_dtype"]),
                                          acc_dtype=getattr(torch, lowp["sum_dtype"]), **kw)
        err = max(err, compare.max_rel_err(pr, want))
    return {"pagerank_rel_err": err}


__all__ = ["UNIT", "Requests", "draw", "Driver", "check"]
