"""Multi-rank temporal analytics on the PyTorch port: the paper's engine on
a device mesh (the counterpart of ``examples/distributed_analytics.py``,
with the same output).

Runs the edge-partitioned EA engine (scan + selective paths) on a
``("data", "model")`` mesh over every rank of a ``torch.distributed`` group
and verifies both against the single-device engine:

  PYTHONPATH=src python examples/distributed_analytics_torch.py --device cpu
      # 8 spawned gloo ranks on a (4, 2) mesh, as the reference uses 8
      # host devices
  PYTHONPATH=src torchrun --nproc-per-node N examples/distributed_analytics_torch.py
      # N ranks, one card each, on NCCL: a (N/2, 2) mesh (N even), else (N, 1)

Without ``--device`` it runs on the cards and needs ``torchrun``'s
environment; with ``--device cpu`` outside ``torchrun`` it spawns
``--ranks`` gloo ranks itself.
"""
import argparse
import os
import pickle
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core.algorithms import earliest_arrival  # noqa: E402
from repro_torch.core.edgemap import INT_INF  # noqa: E402
from repro_torch.data.generators import power_law_temporal_graph  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed import graph_engine as ge  # noqa: E402
from repro_torch.distributed import init_process_group, make_mesh  # noqa: E402
from repro_torch.engine.plan import make_plan  # noqa: E402

SOURCES = (0, 1, 2, 3)
# the selective path's gather budget over all edge shards: the reference's
# 4096 edges a shard on its 4 edge shards.  A budget is per shard, so a
# mesh of fewer edge shards gathers more a shard (4096 a shard on one shard
# would cut the window's edges and miss arrivals)
SELECTIVE_BUDGET = 4 * 4096


def mesh_shape(world: int):
    """(data, model): two source shards where the ranks pair up."""
    return (world // 2, 2) if world % 2 == 0 and world > 1 else (world, 1)


def run(n_vertices=500, n_edges=20_000, seed=11, device=None):
    """On every rank of the process group: both distributed EA paths and the
    single-device engine, as host values (the same on every rank)."""
    device = resolve_device(device)
    mesh = make_mesh(mesh_shape(dist.get_world_size()), ("data", "model"),
                     device=device)
    g = power_law_temporal_graph(n_vertices, n_edges, seed=seed, device=device)
    ts = g.t_start.cpu().numpy()
    win = (int(np.quantile(ts, 0.7)), int(g.t_end.max()))
    S = len(SOURCES)
    arr0 = torch.full((S, g.n_vertices), INT_INF, dtype=torch.int32)
    arr0[torch.arange(S), torch.tensor(SOURCES)] = win[0]

    # scan path: edges sharded over data, sources over model
    edges = ge.shard_edges(mesh, g.src, g.dst, g.t_start, g.t_end)
    evalid = ge.shard_edges(mesh, torch.ones(g.n_edges, dtype=torch.bool))[0]
    scan = ge.run_distributed_ea(mesh, arr0, edges, evalid, win, max_rounds=64)

    # selective path: per-shard time-first order + budget gather
    *sorted_edges, svalid = ge.sort_edges_by_time_per_shard(
        mesh, g.src, g.dst, g.t_start, g.t_end)
    budget = -(-SELECTIVE_BUDGET // mesh.shape[0])
    sel = ge.run_distributed_ea(mesh, arr0, sorted_edges, svalid, win, max_rounds=64,
                                plan=make_plan("index", budget=budget),
                                edges_time_sorted=True)

    ref = np.stack([earliest_arrival(g, s, win).cpu().numpy() for s in SOURCES])
    scan, sel = scan.cpu().numpy(), sel.cpu().numpy()
    return {"mesh": dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape))),
            "window": win, "n_vertices": g.n_vertices, "scan": scan, "selective": sel,
            "single": ref, "scan_equal": bool((scan == ref).all()),
            "selective_equal": bool((sel == ref).all()),
            "reach": int((ref[0] < INT_INF).sum())}


def _rank(rank, world, tmp, kwargs):
    torch.set_num_threads(1)
    init_process_group("cpu", init_method=f"file://{tmp}/store", world_size=world,
                       rank=rank)
    out = run(**kwargs, device="cpu")
    if rank == 0:
        with open(os.path.join(tmp, "result.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn_cpu(world=8, **kwargs):
    """``run`` on ``world`` spawned gloo ranks; rank 0's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(world, tmp, kwargs), nprocs=world,
                           start_method="spawn")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the cards)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="gloo ranks to spawn with --device cpu outside torchrun")
    ap.add_argument("--n-vertices", type=int, default=500)
    ap.add_argument("--n-edges", type=int, default=20_000)
    args = ap.parse_args(argv)
    kwargs = dict(n_vertices=args.n_vertices, n_edges=args.n_edges)
    if "WORLD_SIZE" in os.environ:
        device = resolve_device(args.device)
        init_process_group(device)
        try:
            r = run(**kwargs, device=device)
        finally:
            dist.destroy_process_group()
        if int(os.environ.get("RANK", 0)):
            return r
    elif args.device is not None and torch.device(args.device).type == "cpu":
        r = spawn_cpu(args.ranks, **kwargs)
    else:
        raise SystemExit("run under torchrun on the cards, or pass --device cpu")
    print("mesh:", r["mesh"])
    print("scan path == single-device:", r["scan_equal"])
    print("selective path == single-device:", r["selective_equal"])
    print(f"source {SOURCES[0]}: {r['reach']}/{r['n_vertices']} reachable in window")
    return r


if __name__ == "__main__":
    main()
