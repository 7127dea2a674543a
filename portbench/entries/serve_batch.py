"""Request kind ``serve_batch``: one multi-tenant serving chain; a request
is one advance of the sliding batch through ``repro_torch.serve.serve_batch``.

The traffic file names the tenants, their source sets (``count`` vertices
at even quantiles, by rank as drawn, of those with an edge starting after
the stream's start, or the first ``count`` of another set), the plan
(``access``, ``backend``) and the windows: ``windows`` sliding windows
per tenant of width span / ``width_div`` and stride width /
``stride_div``, the first ending ``start_share`` of the way through the
time range: every seed serves the same windows of the same graph, under
its own vertex ids (the builder's ``relabel``), so the same work.  Set-up serves the cold
start and ``warm_advances`` advances; the window goes on down the chain,
which restarts cold if it ever reaches the end of the time range (that
advance counts).  The check recomputes every row of the sampled advances
with the plain reference."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import compare, temporal

UNIT = "advance"


class Requests(NamedTuple):
    base0: int
    stride: int
    width: int
    count: int
    n_advances: int
    sources: dict          # source set name -> list of vertex ids


def draw(traffic: dict, config: dict, edges, seed: int, device) -> Requests:
    del device
    t_lo, t_hi = int(edges.ts.min()), int(edges.te.max())
    width = (t_hi - t_lo) // traffic["width_div"]
    stride = max(width // traffic["stride_div"], 1)
    count = traffic["windows"]
    start = t_lo + int(traffic["start_share"] * (t_hi - t_lo))
    base0 = start + width + (count - 1) * stride
    n_advances = (t_hi - base0) // stride + 1
    # sources at even quantiles, by rank (the id as drawn), of the vertices
    # active after the start: the same vertices of the graph under every
    # seed's relabelling
    drawn_id = np.argsort(edges.relabel)
    active = np.unique(drawn_id[edges.src[edges.ts >= start]])
    sources = {}
    for name, spec in traffic["source_sets"].items():
        if "first_of" in spec:
            sources[name] = sources[spec["first_of"]][:spec["count"]]
        else:
            q = np.linspace(0, 1, spec["count"], endpoint=False)
            sources[name] = [int(edges.relabel[active[int(len(active) * x)]]) for x in q]
    del seed    # the graph's relabelling is the seed's part
    return Requests(base0, stride, width, count, n_advances, sources)


def windows_at(req: Requests, k: int) -> np.ndarray:
    from repro_torch.serve import sliding_windows

    base = req.base0 + (k % req.n_advances) * req.stride
    return sliding_windows(base, req.width, req.stride, req.count)


class Driver:
    def __init__(self, system, req: Requests, traffic: dict, config: dict, device):
        self.g, self.tger = system.g, system.tger
        self.req, self.traffic = req, traffic
        self.state = None
        self.first = 0

    def batch(self, k: int):
        from repro_torch.engine import QueryBatch, QuerySpec

        specs = []
        for w in windows_at(self.req, k):
            w = (int(w[0]), int(w[1]))
            for t in self.traffic["tenants"]:
                src = self.req.sources[t["sources"]] if "sources" in t else None
                specs.append(QuerySpec.make(t["algorithm"], w, sources=src,
                                            **t.get("params", {})))
        return QueryBatch.make(specs)

    def advance(self, k: int):
        from repro_torch.serve import serve_batch

        batch = self.batch(k)
        if k % self.req.n_advances == 0:
            self.state = None
        results, self.state = serve_batch(self.g, batch, self.tger, state=self.state,
                                          access=self.traffic["access"],
                                          backend=self.traffic["backend"])
        return batch, results

    def warm(self):
        for k in range(self.traffic["warm_advances"] + 1):
            self.advance(k)
        self.first = self.traffic["warm_advances"] + 1

    def request(self, i: int):
        batch, results = self.advance(self.first + i)
        st = self.state
        return (batch, results), {"advances": 1, "rows_solved_unique": st.n_solved_unique,
                                  "rows_solved": st.n_solved}

    def release(self):
        self.state = None
        self.g = self.tger = None


def check(ctx, samples, control=None) -> dict:
    """Every row of each sampled advance against the reference: EA, BFS
    (hops and arrivals) and CC exactly, PageRank by its largest relative
    error.  With ``control`` (the configuration's ``control`` entry) the
    reference computed in the lower precision stands in for the program's
    rows."""
    edges, dev = ctx.inputs, ctx.device
    lowp = ctx.config["control"] if control else None
    V = edges.n_vertices
    out = {"ea_mismatch": 0, "bfs_mismatch": 0, "cc_mismatch": 0, "pagerank_rel_err": 0.0}
    pr_iters = {t["algorithm"]: t.get("params", {}).get("n_iters")
                for t in ctx.traffic["tenants"]}.get("pagerank")
    for _, (batch, results) in samples:
        for (key, rows), res in zip(batch.groups().items(), results):
            alg = key[0]
            for w in sorted({r.window for r in rows}):
                idx = [j for j, r in enumerate(rows) if r.window == w]
                win = tuple(edges_of(edges, w))
                if alg in ("earliest_arrival", "bfs"):
                    srcs = sorted({rows[j].source for j in idx})
                    at = [srcs.index(rows[j].source) for j in idx]
                    verts, arr, hops = temporal.bellman_ford(*win, srcs, w, device=dev,
                                                             hops=True)
                    got_arr = res[1] if alg == "bfs" else res
                    if lowp:
                        _, arr_c, hops_c = temporal.bellman_ford(
                            *win, srcs, w, device=dev, hops=True,
                            time_dtype=getattr(torch, lowp["time_dtype"]))
                        got = _dense(arr_c[at], verts, V, dev)
                        got_h = _dense(hops_c[at], verts, V, dev)
                    else:
                        got = got_arr[idx]
                        got_h = res[0][idx] if alg == "bfs" else None
                    miss = compare.sparse_mismatch(got, verts, arr[at])
                    if alg == "bfs":
                        miss += compare.sparse_mismatch(got_h, verts, hops[at])
                        out["bfs_mismatch"] += miss
                    else:
                        out["ea_mismatch"] += miss
                elif alg == "cc":
                    want = temporal.connected_components(*win, V, w)
                    for j in idx:
                        got = want if lowp else res[j]
                        out["cc_mismatch"] += compare.dense_mismatch(got, want)
                elif alg == "pagerank":
                    want = temporal.pagerank(*win, V, w, pr_iters, device=dev)
                    if lowp:
                        dt = getattr(torch, lowp["rank_dtype"])
                        low = temporal.pagerank(*win, V, w, pr_iters, device=dev, dtype=dt)
                    for j in idx:
                        got = low if lowp else res[j]
                        out["pagerank_rel_err"] = max(out["pagerank_rel_err"],
                                                      compare.max_rel_err(got, want))
                else:
                    raise ValueError(f"no reference for {alg!r}")
    return out


def edges_of(edges, window):
    """The window's edges of the benchmark's own arrays."""
    return temporal.window_edges(edges.src, edges.dst, edges.ts, edges.te, window)


def _dense(rows_compact, verts, n_vertices, device):
    """[R, n] answers on ``verts`` as [R, V] rows, ``INF`` elsewhere."""
    out = torch.full((rows_compact.shape[0], n_vertices), temporal.INF,
                     dtype=torch.int64, device=device)
    out[:, verts] = rows_compact
    return out


__all__ = ["UNIT", "Requests", "draw", "Driver", "check"]
