"""The paper's own workload: billion-edge temporal graph analytics cells.

Shapes follow the paper's synthetic dataset (§6: |V|=1e7, |E|=1e9) with the
100-source query batches of Table 4 (rounded to 128 to shard over `model`).
Four cells mirror the paper's algorithm classes:

  ea_scan_1b       minimal paths, T-CSR scan path (Temporal-Ligra baseline)
  ea_selective_1b  minimal paths, TGER index path (selective indexing)
  cc_1b            temporal connectivity round
  pagerank_1b      temporal centrality round (PR power iteration)

and two the exchange flag of the distributed round adds (``ea_sparse_1b``,
``ea_selsparse_1b``: the top-K exchange without and with the index gather).
The rounds are ``repro_torch.distributed.graph_engine``'s.

``KairosFamily.dry_program`` (the reference's ``lowerable``) gives a cell's
round and this rank's arguments on meta tensors for ``launch/dryrun.py``:
the [S / model, V] source rows, the five edge columns' chunk of E / (pod x
data) and the window, a host pair.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchSpec, Cell, register
from repro_torch.device import resolve_device, to_numpy

I32 = torch.int32
F32 = torch.float32

KAIROS_CELLS = {
    "ea_scan_1b": Cell(
        "ea_scan_1b", "analytics",
        dict(n_vertices=10_000_000, n_edges=1_000_000_000, sources=128, access="scan"),
    ),
    "ea_selective_1b": Cell(
        "ea_selective_1b", "analytics",
        dict(n_vertices=10_000_000, n_edges=1_000_000_000, sources=128,
             access="index", budget_per_shard=1 << 17),
    ),
    "ea_sparse_1b": Cell(
        "ea_sparse_1b", "analytics",
        dict(n_vertices=10_000_000, n_edges=1_000_000_000, sources=128,
             access="sparse", exchange_budget=1 << 15),
    ),
    "ea_selsparse_1b": Cell(
        "ea_selsparse_1b", "analytics",
        dict(n_vertices=10_000_000, n_edges=1_000_000_000, sources=128,
             access="selsparse", budget_per_shard=1 << 17,
             exchange_budget=1 << 15),
    ),
    "cc_1b": Cell(
        "cc_1b", "analytics",
        dict(n_vertices=10_000_000, n_edges=1_000_000_000, access="scan"),
    ),
    "pagerank_1b": Cell(
        "pagerank_1b", "analytics",
        dict(n_vertices=10_000_000, n_edges=1_000_000_000, access="scan"),
    ),
}


def cell_plan(cell: Cell):
    """The distributed EA round's plan for an ``ea_*`` cell: the access
    string maps onto the round's two flags (the index gather's budget, the
    top-K exchange's budget), as the reference's ``lowerable`` maps it."""
    from repro_torch.engine.plan import make_plan

    m = cell.meta
    gather = m["access"] in ("index", "selsparse")
    return make_plan(
        "index" if gather else "scan",
        budget=m["budget_per_shard"] if gather else 0,
        exchange_budget=m["exchange_budget"] if m["access"] in ("sparse", "selsparse") else 0,
    )


@contextlib.contextmanager
def one_rank_group(device):
    """The process group the smoke run's mesh needs: the caller's when one
    is initialised, else a group of one rank (gloo on the CPU, NCCL on a
    card) over a file store, destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    from repro_torch.distributed import init_process_group

    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(device, init_method="file://" + os.path.join(tmp, "store"),
                           world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


class KairosFamily(ArchSpec):
    family = "kairos"
    source = "this paper (da Trindade et al., CS.DB 2024), synthetic dataset of §6"

    def __init__(self):
        self.arch_id = "kairos"
        self.cells = dict(KAIROS_CELLS)

    def dry_program(self, cell_name: str, mesh):
        """(round, args) of the cell on ``mesh`` for the dry run: the
        ``graph_engine`` round of the cell (the EA round from ``cell_plan``)
        and this rank's meta arguments, as a round function takes them —
        its source rows (``local_rows`` of the [S, V] state), its chunk of
        each edge column and the window (an int32 pair on the host)."""
        from repro_torch.distributed import graph_engine as ge

        cell = self.cells[cell_name]
        m = cell.meta
        V, E = m["n_vertices"], m["n_edges"]
        meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
        n_shards = ge.edge_mesh_axis(mesh).size
        per = -(-E // n_shards)
        edges = [meta((per,), I32) for _ in range(4)] + [meta((per,), torch.bool)]
        window = torch.tensor([0, np.iinfo(np.int32).max - 1], dtype=I32)
        if cell.name.startswith("ea"):
            rows = ge.local_rows(mesh, meta((m["sources"], V), I32)).clone()
            return ge.make_ea_round_plan(mesh, V, cell_plan(cell)), (rows, *edges, window)
        if cell.name.startswith("cc"):
            return ge.make_cc_round(mesh, V), (meta((V,), I32), *edges, window)
        inv_deg = meta((V,), F32)
        return ge.make_pagerank_round(mesh, V), (meta((V,), F32), *edges, inv_deg,
                                                 window)

    def model_flops(self, cell_name: str) -> float:
        """Useful work per round: ~8 VPU ops per (edge x query) touched.
        The selective cell touches only its gathered budget — that ratio IS
        the paper's selective-indexing saving."""
        cell = self.cells[cell_name]
        m = cell.meta
        s = m.get("sources", 1)
        if m["access"] in ("index", "selsparse"):
            touched = m["budget_per_shard"] * 512.0  # per-shard budget x shards
        else:
            touched = float(m["n_edges"])            # scan & sparse relax all edges
        return 8.0 * touched * s

    def smoke(self, seed: int = 0, device=None):
        """Distributed rounds on a (1, 1) mesh against the single-device
        engine, on ``device`` (the first CUDA card unless given)."""
        from repro_torch.core.algorithms import earliest_arrival
        from repro_torch.data.generators import synthetic_temporal_graph
        from repro_torch.distributed import graph_engine as ge
        from repro_torch.distributed import make_mesh
        from repro_torch.kernels.temporal_edgemap import INT_INF

        device = resolve_device(device)
        g = synthetic_temporal_graph(80, 600, seed=seed, device=device)
        ts = to_numpy(g.t_start)
        win = (int(np.quantile(ts, 0.3)), int(ts.max() + 10))
        sources = [0, 3]
        with one_rank_group(device):
            mesh = make_mesh((1, 1), ("data", "model"), device=device)
            arr0 = torch.full((2, g.n_vertices), INT_INF, dtype=I32, device=device)
            arr0[torch.arange(2), torch.tensor(sources)] = win[0]
            edges = ge.shard_edges(mesh, g.src, g.dst, g.t_start, g.t_end)
            evalid = ge.shard_edges(mesh, torch.ones(g.n_edges, dtype=torch.bool))[0]
            out = ge.run_distributed_ea(mesh, arr0, edges, evalid, win, max_rounds=40)
        ref = torch.stack([earliest_arrival(g, s, win) for s in sources])
        return {
            "matches_single_device": bool(torch.equal(out.cpu(), ref.cpu())),
            "finite": True,
        }


@register("kairos")
def _build() -> KairosFamily:
    return KairosFamily()


__all__ = ["KAIROS_CELLS", "KairosFamily", "cell_plan"]
