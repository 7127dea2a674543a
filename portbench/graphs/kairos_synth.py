"""The paper's synthetic graph (§6: |V| 1e7, |E| 1e9), drawn on the device
from the seed, and loaded into the port's distributed engine on a
one-rank process group: ``sort_edges_by_time_per_shard`` sorts the edges
by start time for the selective round.

``generate`` is a frozen copy of the draw the chip smoke run uses
(``kairos_edges``): endpoints of lognormal rank, start times the
cumulative sum of Poisson gaps in a random order, durations uniform up to
a tenth of the last start.  The configuration's ``graph_seed`` draws that
graph, so every run holds the same edges, and the run's seed relabels its
vertices (a random permutation): each seed gets the same graph under other
names and draws its own traffic, so seeds differ in their queries and not
in the amount of work the graph makes (the draw's scale, ``raw.max()``,
moves with the seed, and with it the hubs' ids and how their atomics
contend).  Without ``graph_seed`` the run's seed draws the graph.  It also
keeps what traffic needs to find a window's edges without the program:
the start times in time order (``t_sorted``, the cumulative sum before
the shuffle) and the edge at each time position (``edge_at``).  The same
seed on the same device gives the same edges, so the reference draws them
again after the window."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

CHUNK = 1 << 27   # elements a pass while drawing


def _slices(n, per=CHUNK):
    return [slice(lo, min(lo + per, n)) for lo in range(0, n, per)]


class Edges:
    """The raw edges (int32 on the device) and the time-order aids."""

    def __init__(self, src, dst, ts, te, t_sorted, edge_at, n_vertices):
        self.src, self.dst, self.ts, self.te = src, dst, ts, te
        self.t_sorted, self.edge_at = t_sorted, edge_at
        self.n_vertices = n_vertices
        self.n_edges = int(src.shape[0])

    def chunks(self):
        return [(self.src[sl], self.dst[sl], self.ts[sl], self.te[sl])
                for sl in _slices(self.n_edges)]

    def drop(self, *names):
        for n in names:
            setattr(self, n, None)


def generate(config: dict, seed: int, device, with_order: bool = True) -> Edges:
    n_v, n_e = config["vertices"], config["edges"]
    lam = config["assumed"]["poisson_gap"]
    gen = torch.Generator(device=device)
    gen.manual_seed(config.get("graph_seed", seed))
    chunks = _slices(n_e)

    def pick():
        raw = torch.empty(n_e, dtype=torch.float32, device=device).normal_(generator=gen)
        raw.exp_()
        scale = (n_v - 1) / raw.max()
        out = torch.empty(n_e, dtype=torch.int32, device=device)
        for sl in chunks:
            out[sl] = (raw[sl] * scale).to(torch.int32).clamp_(0, n_v - 1)
        return out

    src = pick()
    dst = pick()
    for sl in chunks:
        d = dst[sl]
        d.copy_(torch.where(src[sl] == d, torch.remainder(d + 1, n_v), d))
    t = torch.empty(n_e, dtype=torch.int32, device=device)
    carry = 0
    for sl in chunks:
        rate = torch.full((sl.stop - sl.start,), lam, device=device)
        c = torch.poisson(rate, generator=gen).to(torch.int64).cumsum(0) + carry
        t[sl] = c.to(torch.int32)
        carry = int(c[-1])
    keys = torch.randint(0, 2**31 - 1, (n_e,), dtype=torch.int32, device=device,
                         generator=gen)
    perm = torch.sort(keys)[1]          # the shuffle of the start times
    del keys
    ts = t[perm]
    edge_at = None
    if with_order:
        edge_at = torch.empty(n_e, dtype=torch.int32, device=device)
        edge_at[perm] = torch.arange(n_e, dtype=torch.int32, device=device)
    del perm
    max_duration = max(int(ts.max()) // 10, 1)
    te = torch.empty_like(ts)
    for sl in chunks:
        te[sl] = ts[sl] + torch.randint(0, max_duration + 1, (sl.stop - sl.start,),
                                        dtype=torch.int32, device=device, generator=gen)
    if "graph_seed" in config:
        names = torch.Generator(device=device)
        names.manual_seed(seed)
        perm = torch.randperm(n_v, generator=names, device=device).to(torch.int32)
        for a in (src, dst):
            for sl in chunks:
                a[sl] = perm[a[sl].long()]
    return Edges(src, dst, ts, te, t if with_order else None, edge_at, n_v)


class System:
    """The sorted edge chunks and the mesh of the one-rank group."""

    def __init__(self, mesh, edges, valid, n_vertices, n_edges, stack):
        self.mesh, self.edges, self.valid = mesh, edges, valid
        self.n_vertices, self.n_edges = n_vertices, n_edges
        self._stack = stack


@contextlib.contextmanager
def _store_dir():
    with tempfile.TemporaryDirectory(prefix="portbench-store-") as tmp:
        yield os.path.join(tmp, "store")


def load(config: dict, edges: Edges, device, sync):
    """A one-rank process group (NCCL on the card, gloo on the CPU; its
    store in a temporary directory), the ``("data", "model")`` mesh, and
    the edges sorted by start time per shard.  Returns ``(system,
    seconds)``, the seconds of the sort (host clock, synchronized).  Lets
    go of ``edges``' arrays (the check draws them again)."""
    import torch.distributed as dist

    from repro_torch.distributed import graph_engine as ge
    from repro_torch.distributed import init_process_group, make_mesh

    edges.drop("t_sorted", "edge_at")
    stack = contextlib.ExitStack()
    store = stack.enter_context(_store_dir())
    init_process_group(device, init_method="file://" + store, world_size=1, rank=0)
    stack.callback(dist.destroy_process_group)
    mesh = make_mesh((1, 1), ("data", "model"), device=device)
    sync()
    t0 = time.perf_counter()
    src, dst, ts, te, valid = ge.sort_edges_by_time_per_shard(
        mesh, edges.src, edges.dst, edges.ts, edges.te)
    sync()
    seconds = time.perf_counter() - t0
    edges.drop("src", "dst", "ts", "te")
    return System(mesh, (src, dst, ts, te), valid, edges.n_vertices, edges.n_edges,
                  stack), seconds


def close(system: System) -> None:
    system.edges = system.valid = None
    system._stack.close()


__all__ = ["Edges", "System", "generate", "load", "close"]
