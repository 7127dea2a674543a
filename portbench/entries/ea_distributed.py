"""Request kind ``ea_distributed``: a multi-source earliest-arrival query
through the distributed engine, ``run_distributed_ea`` on the one-rank
mesh with a selective plan (``make_plan(access, budget=budget)``: the
index gather of at most ``budget`` edges that start in the window, on
edges sorted by start time; ``edges_time_sorted=True``,
``with_rounds=True``).  The request builds the [S, V] initial state and
runs the query.

Each of ``queries`` windows starts at a seeded time position in the
middle half of the time-sorted edges and is sized by the edges that lie
inside it (``ts >= ta`` and ``te <= tb``): its end is the
``window_edges_inside``-th smallest end time among the ``budget`` edges
that start first in it, or earlier where that would let more than
``budget`` edges start in it.  So every window holds that many complete
edges (fewer only where the budget caps it), whatever the seed.  Its
``sources`` sources are the start vertices of the edges inside it, in a
seeded order, topped up with start vertices of edges that start in it.
The check draws the edges again from the seed (the program's sorted copy
is not used) and recomputes each sampled query."""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from portbench.reference import compare, temporal

UNIT = "query"
INF = temporal.INF


class Requests(NamedTuple):
    windows: np.ndarray           # i64[Q, 2]
    sources: List[torch.Tensor]   # Q x i64[S] on the device
    inside: np.ndarray            # i64[Q]: edges that lie inside each window
    starts: np.ndarray            # i64[Q]: edges that start in each window


def window_positions(t_sorted, window):
    """[lo, hi): the time positions whose start lies in the window."""
    ta, tb = window
    b = torch.tensor([ta, tb], dtype=t_sorted.dtype, device=t_sorted.device)
    lo = int(torch.searchsorted(t_sorted, b[:1], side="left"))
    hi = int(torch.searchsorted(t_sorted, b[1:], side="right"))
    return lo, hi


def draw(traffic: dict, config: dict, edges, seed: int, device) -> Requests:
    """The windows and their sources, a batch of windows at a time on the
    device: the end times of the ``budget`` edges that start first in each
    window set its end, and its inside edges' start vertices go to the
    host at once."""
    E = edges.n_edges
    budget, S, Q = traffic["budget"], traffic["sources"], traffic["queries"]
    k = min(traffic["window_edges_inside"], budget)
    rng = np.random.default_rng([seed, 1])
    t = edges.t_sorted
    pos = torch.as_tensor(rng.integers(E // 4, 3 * E // 4, size=Q), device=t.device)
    ta = t[pos]
    lo = torch.searchsorted(t, ta, side="left")
    # the last end that lets at most ``budget`` edges start in the window
    cap = torch.where(lo + budget < E, t[(lo + budget).clamp(max=E - 1)] - 1, t[-1])
    span = torch.arange(budget, device=t.device)
    windows, inside_n, starts_n, sources = [], [], [], []
    per = max(1, (1 << 25) // budget)
    for b0 in range(0, Q, per):
        b = slice(b0, min(b0 + per, Q))
        at = lo[b, None] + span[None, :]
        real = at < E
        ids = edges.edge_at[at.clamp(max=E - 1)].long()
        te = torch.where(real, edges.te[ids], torch.iinfo(edges.te.dtype).max)
        tb = torch.maximum(torch.minimum(te.kthvalue(k, dim=1).values, cap[b]), ta[b])
        inside = real & (te <= tb[:, None])
        hi = torch.searchsorted(t, tb, side="right")
        windows.append(torch.stack([ta[b], tb], 1).long().cpu())
        inside_n.append(inside.sum(1).cpu())
        starts_n.append((hi - lo[b]).cpu())
        row, col = inside.nonzero(as_tuple=True)
        s_in = edges.src[ids[row, col]].cpu().numpy()
        row = row.cpu().numpy()
        for j in range(tb.shape[0]):
            pick = rng.permutation(np.unique(s_in[row == j]))[:S]
            if len(pick) < S:
                n = int(starts_n[-1][j])
                s_any = edges.src[ids[j, :n]].unique().cpu().numpy()
                rest = np.setdiff1d(s_any, pick)
                pick = np.concatenate([pick, rng.permutation(rest)[:S - len(pick)]])
            if len(pick) < S:
                raise ValueError(f"window {b0 + j} ({n} edge starts) gave {len(pick)} "
                                 f"distinct sources, {S} asked")
            sources.append(torch.as_tensor(pick, dtype=torch.int64, device=device))
    return Requests(torch.cat(windows).numpy(), sources, torch.cat(inside_n).numpy(),
                    torch.cat(starts_n).numpy())


class Driver:
    def __init__(self, system, req: Requests, traffic: dict, config: dict, device):
        from repro_torch.engine.plan import make_plan

        self.sys, self.req, self.traffic, self.device = system, req, traffic, device
        self.plan = make_plan(traffic["access"], budget=traffic["budget"])

    def query(self, q: int):
        from repro_torch.distributed import graph_engine as ge

        ta, tb = (int(x) for x in self.req.windows[q])
        src = self.req.sources[q]
        arrival0 = torch.full((src.shape[0], self.sys.n_vertices), INF, dtype=torch.int32,
                              device=self.device)
        arrival0[torch.arange(src.shape[0], device=self.device), src] = ta
        return ge.run_distributed_ea(self.sys.mesh, arrival0, self.sys.edges, self.sys.valid,
                                     (ta, tb), max_rounds=self.traffic["max_rounds"],
                                     plan=self.plan, edges_time_sorted=True,
                                     with_rounds=True)

    def warm(self):
        for q in range(self.traffic["warm_queries"]):
            self.query(len(self.req.windows) - 1 - q)

    def request(self, i: int):
        q = i % len(self.req.windows)
        arrival, rounds = self.query(q)
        return (q, arrival), {"queries": 1, "rounds": rounds,
                              "window_edges": int(self.req.inside[q])}

    def release(self):
        self.sys = None


def check(ctx, samples, control=None) -> dict:
    """Every row of each sampled query against the reference's EA over the
    window's edges, exactly; with ``control`` the reference with the times
    in the configuration's lower precision stands in for the program."""
    lowp = ctx.config["control"] if control else None
    edges = ctx.builder.generate(ctx.config, ctx.seed, ctx.device)
    miss = 0
    for _, (q, arrival) in samples:
        window = tuple(int(x) for x in ctx.requests.windows[q])
        lo, hi = window_positions(edges.t_sorted, window)
        ids = edges.edge_at[lo:hi].long()
        win = [a[ids] for a in (edges.src, edges.dst, edges.ts, edges.te)]
        srcs = ctx.requests.sources[q]
        verts, want = temporal.bellman_ford(*win, srcs, window, device=ctx.device)
        if lowp:
            _, low = temporal.bellman_ford(*win, srcs, window, device=ctx.device,
                                           time_dtype=getattr(torch, lowp["time_dtype"]))
            got = torch.full((srcs.shape[0], edges.n_vertices), INF, dtype=torch.int32,
                             device=ctx.device)
            got[:, verts] = low.to(torch.int32)
        else:
            got = arrival
        miss += compare.sparse_mismatch(got, verts, want)
    return {"ea_mismatch": miss}


__all__ = ["UNIT", "Requests", "draw", "Driver", "check", "window_positions"]
