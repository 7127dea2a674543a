"""Serving driver: continuous batching of a (reduced-config) LM, or
sliding-window temporal-graph serving (the port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch smollm-135m]
        [--requests 16] [--slots 4] [--max-new 12] [--prompt-len 16]
        [--max-seq 64] [--seed 0] [--device cpu]

    # graph mode: multi-tenant QueryBatch advances on a synthetic graph;
    # --history-chunks N attaches a cold store and answers a time-travel
    # query over an evicted window at the end
    PYTHONPATH=src python -m repro_torch.launch.serve --graph --tenants 16 \
        --advances 24 [--history-chunks 1024] [--device cpu]

    # daemon mode: a tick loop with Poisson tenant arrivals and departures,
    # bucketed admission, cost-class round-robin; --history-chunks N admits
    # a pinned historical tenant mid-run
    PYTHONPATH=src python -m repro_torch.launch.serve --graph --daemon \
        --ticks 40 --arrival-rate 0.5 --depart-rate 0.25 [--device cpu]

    # sharded graph / daemon serving: one process per rank, the process
    # group from torchrun's environment (NCCL on the cards, gloo with
    # --device cpu); every rank computes, rank 0 prints
    torchrun --nproc-per-node N -m repro_torch.launch.serve --graph \
        [--daemon] --shard-queries D [--shard-edges E]

As in the reference the LM mode serves the architecture's reduced config
(``smoke_cfg``) with random weights from ``--seed``.  Everything runs on
the first CUDA card unless ``--device`` names another (under torchrun,
rank r's card is ``LOCAL_RANK``); without a card and without ``--device``
it raises.  ``--shard-queries D`` shards the tenant axis over D ranks,
``--shard-edges E`` also the ring's slot axis (an (E, D) mesh); the mesh
must cover the whole process group, and a flag without a process group of
that size raises ``ValueError``.  With ``--history-chunks`` the graph and
daemon modes serve unsharded, as the reference does.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, to_numpy
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import (
    EngineStats,
    GraphBatchServer,
    GraphServeStats,
    Request,
    ServeEngine,
)

GRAPH_ALGORITHMS = ("earliest_arrival", "reachability", "bfs", "cc", "pagerank")


def _say(*a) -> None:
    """Print on rank 0 only (every rank of a sharded run computes)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*a)


def _mesh(args, coldstore):
    """The serving mesh the --shard-* flags ask for (None with a cold
    store: its history tier is unsharded)."""
    if coldstore is not None:
        return None
    if args.shard_edges:
        return (args.shard_edges, args.shard_queries or 1)
    return args.shard_queries


def _graph(args):
    """The synthetic power-law graph and its TGER, with the time span's
    minimum start, span and maximum end."""
    from repro_torch.core.tger import build_tger
    from repro_torch.data.generators import power_law_temporal_graph

    g = power_law_temporal_graph(args.n_vertices, args.n_edges, seed=args.seed,
                                 device=resolve_device(args.device))
    idx = build_tger(g, degree_cutoff=max(args.n_edges // 800, 16))
    ts = to_numpy(g.t_start)
    t_max = int(to_numpy(g.t_end).max())
    return g, idx, int(ts.min()), int(ts.max() - ts.min()), t_max


def _coldstore(args, g, idx):
    if not args.history_chunks:
        return None
    from repro_torch.core.coldstore import ColdStore

    return ColdStore(g, idx, chunk_slots=args.history_chunks,
                     spill_dir=args.history_spill_dir)


def run_graph(args) -> GraphServeStats:
    """Graph mode: ``args.advances`` sliding advances of a tenant batch on
    an index plan; with a cold store, then one time-travel batch over an
    evicted window.  Prints the reference's summary lines and returns the
    server's stats."""
    from repro_torch.engine import QueryBatch, QuerySpec

    g, idx, t_min, span, t_max = _graph(args)
    width = max(span // 80, 1)
    stride = max(width // 8, 1)
    base0 = t_max - (args.advances + 2) * stride

    def make_batch(base):
        specs = []
        for i in range(args.tenants):
            alg = GRAPH_ALGORITHMS[i % len(GRAPH_ALGORITHMS)]
            off = (i % 2) * stride
            win = (int(base - off - width), int(base - off))
            if alg == "cc":
                specs.append(QuerySpec.make(alg, win))
            elif alg == "pagerank":
                specs.append(QuerySpec.make(alg, win, n_iters=8))
            else:
                specs.append(QuerySpec.make(
                    alg, win, sources=(7 * i) % args.n_vertices))
        return QueryBatch.make(specs)

    coldstore = _coldstore(args, g, idx)
    server = GraphBatchServer(g, idx, access="index", coldstore=coldstore,
                              mesh=_mesh(args, coldstore))
    t0 = time.perf_counter()
    for k in range(args.advances):
        server.advance(make_batch(base0 + k * stride))
    dt = time.perf_counter() - t0
    s = server.stats
    rate = s.rows_served / max(dt, 1e-9)
    _say(
        f"served {s.rows_served} query rows ({s.rows_solved} solved after "
        f"dedup) in {s.advances} advances ({s.cold_advances} cold, "
        f"{s.fused_dispatches} fused dispatches) on {server.devices} "
        f"device(s), {dt:.2f}s ({rate:.1f} rows/s)"
    )
    if coldstore is not None:
        # time travel: a window the sweep evicted long ago serves from the
        # compacted cold tier, not a full-history rebuild
        hist_base = t_min + span // 8 + width
        hist = QueryBatch.make([
            QuerySpec.make("earliest_arrival", (hist_base - width, hist_base),
                           sources=1),
            QuerySpec.make("cc", (hist_base - width, hist_base)),
        ])
        t0 = time.perf_counter()
        server.advance(hist)
        dt_hist = time.perf_counter() - t0
        st = coldstore.stats()
        _say(
            f"history: tier={server.state.plan.tier!r} time-travel answered in "
            f"{1e3 * dt_hist:.1f} ms; cold store {st['n_chunks']} chunks "
            f"({st['sealed_slots']} slots sealed, watermark "
            f"{st['watermark']}), compaction {st['compaction_ratio']:.2f}x"
        )
    return server.stats


def run_daemon(args) -> GraphServeStats:
    """Daemon mode: Poisson tenant arrivals and departures over the five
    cost-classed algorithms, admission at tick boundaries, per-class
    bucketed chains; with a cold store, a pinned historical tenant arrives
    mid-run.  Prints the reference's summary lines and returns the
    server's stats."""
    from repro_torch.engine import QuerySpec

    g, idx, t_min, span, t_max = _graph(args)
    width = max(span // 80, 1)
    stride = max(width // 8, 1)
    t_base = t_max - (args.ticks + 2) * stride
    rng = np.random.default_rng(args.seed)

    def fresh_spec(i: int) -> QuerySpec:
        alg = GRAPH_ALGORITHMS[i % len(GRAPH_ALGORITHMS)]
        w = (0, width)
        if alg == "cc":
            return QuerySpec.make(alg, w)
        if alg == "pagerank":
            return QuerySpec.make(alg, w, n_iters=8)
        return QuerySpec.make(alg, w, sources=(7 * i) % args.n_vertices)

    coldstore = _coldstore(args, g, idx)
    server = GraphBatchServer(g, idx, access="index", coldstore=coldstore,
                              mesh=_mesh(args, coldstore))
    live: list = [server.submit(fresh_spec(i)) for i in range(args.tenants)]
    n_spawned = args.tenants

    t0 = time.perf_counter()
    for k in range(args.ticks):
        server.tick(t_base + k * stride)
        if coldstore is not None and k == args.ticks // 2:
            # mid-run, a pinned time-travel tenant arrives: its window is
            # fixed in the evicted past, served verbatim via the cold tier
            hist_lo = t_min + span // 8
            live.append(server.submit(QuerySpec.make(
                "cc", (hist_lo, hist_lo + width), pinned=True)))
            n_spawned += 1
        for _ in range(rng.poisson(args.arrival_rate)):
            live.append(server.submit(fresh_spec(n_spawned)))
            n_spawned += 1
        for _ in range(rng.poisson(args.depart_rate)):
            if len(live) > 1:
                server.retire(live.pop(rng.integers(len(live))))
    dt = time.perf_counter() - t0

    s = server.stats
    lat = np.asarray(server.latencies)
    _say(
        f"daemon: {s.ticks} ticks, {s.advances} class advances "
        f"({s.cold_advances} cold, {s.fused_dispatches} fused), "
        f"{s.admissions} admissions / {s.retirements} retirements, "
        f"{s.rows_served} rows served in {dt:.2f}s"
    )
    if coldstore is not None:
        st = coldstore.stats()
        _say(
            f"cold store: {st['n_chunks']} chunks, watermark "
            f"{st['watermark']}, compaction {st['compaction_ratio']:.2f}x"
        )
    _say(
        f"per-advance latency: p50 {1e3 * np.percentile(lat, 50):.2f} ms, "
        f"p99 {1e3 * np.percentile(lat, 99):.2f} ms "
        f"({len(server.tenants)} tenants live at exit)"
    )
    return server.stats


def run_lm(args) -> EngineStats:
    cfg = get_arch(args.arch).smoke_cfg
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    engine = ServeEngine(init_lm(cfg, gen, device), batch_slots=args.slots,
                         max_seq=args.max_seq)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    stats = engine.run()
    dt = time.perf_counter() - t0
    print(
        f"completed {stats.requests_completed}/{args.requests} requests, "
        f"{stats.tokens_generated} tokens in {stats.steps} engine steps, "
        f"{dt:.2f}s ({stats.tokens_generated / max(dt, 1e-9):.1f} tok/s) "
        f"on {engine.model.device}"
    )
    return stats


def main(argv=None):
    """Parse ``argv`` and run the chosen mode; returns its stats
    (``EngineStats`` for the LM, ``GraphServeStats`` for --graph/--daemon)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--graph", action="store_true",
                    help="serve temporal-graph query batches instead of LM")
    ap.add_argument("--tenants", type=int, default=16)
    ap.add_argument("--advances", type=int, default=24)
    ap.add_argument("--n-vertices", type=int, default=2_000)
    ap.add_argument("--n-edges", type=int, default=50_000)
    ap.add_argument("--shard-queries", type=int, default=None,
                    help="shard the tenant axis over N ranks (run under "
                         "torchrun --nproc-per-node N)")
    ap.add_argument("--shard-edges", type=int, default=None,
                    help="also shard the ring's slot axis over E ranks "
                         "(forms an (E, D) edge-query mesh with "
                         "--shard-queries; needs E*D ranks)")
    ap.add_argument("--history-chunks", type=int, default=None,
                    help="attach a cold store compacting evicted ring "
                         "slots into chunks of N slots; graph mode then "
                         "answers a time-travel query over an evicted "
                         "window, daemon mode admits a pinned historical "
                         "tenant mid-run")
    ap.add_argument("--history-spill-dir", default=None, metavar="DIR",
                    help="spill sealed cold-store chunk payloads to "
                         "memmap-backed files under DIR (needs "
                         "--history-chunks); decodes are bit-identical, "
                         "RAM holds only the chunk directory")
    ap.add_argument("--daemon", action="store_true",
                    help="graph daemon mode: tick loop with Poisson churn")
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="Poisson tenant arrivals per tick")
    ap.add_argument("--depart-rate", type=float, default=0.25,
                    help="Poisson tenant departures per tick")
    args = ap.parse_args(argv)

    if args.history_spill_dir and not args.history_chunks:
        ap.error("--history-spill-dir needs --history-chunks (it spills "
                 "the cold store's sealed chunks)")
    own_group = False
    if args.shard_queries or args.shard_edges:
        import torch.distributed as dist

        from repro_torch.distributed import init_process_group, serve_mesh

        device = resolve_device(args.device)
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            # torchrun's environment: NCCL on the cards, gloo on the CPU
            init_process_group(device)
            own_group = True
    try:
        if args.shard_queries or args.shard_edges:
            # the mesh must cover the process group, with or without a cold
            # store (which turns the mesh off)
            serve_mesh(args.shard_edges or 1, args.shard_queries or 1, device=device)
        if args.daemon:
            return run_daemon(args)
        if args.graph:
            return run_graph(args)
        return run_lm(args)
    finally:
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
