#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed S]

1. Requires a CUDA card; prints its name and power limit.
2. Builds the kernels of ``src/repro_torch/kernels/csrc`` with nvcc.
3. Kernel phases, at the main path's tile-layout shapes: each kernel
   against its plain PyTorch version on the card (bit-identical), timed
   beside the plain version, one ``scatter_reduce_`` call and the
   memory-bytes bound.
4. The main path at the shape of SNAP's wiki-talk-temporal (1,140,149
   vertices, 7,833,140 temporal edges), generated from ``--seed`` as a
   power-law and a transit graph: build_tger -> plan_query -> earliest
   arrival under {scan, index, hybrid} x {xla_segment, pallas_tiled}, the
   K2 fixpoint and a sliding-window sweep, all bit-identical to each other
   and to a numpy oracle, with the kernels' launch counts read around it.
5. Prints the kernel table as one JSON line, then the result line.

Any mismatch raises, and the script exits non-zero.  It imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the float32
# rate outside the tensor cores as the rate of the kernels' int32 ops.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
WIKI_TALK_VERTICES = 1_140_149
WIKI_TALK_EDGES = 7_833_140
DEGREE_CUTOFF = 2048  # the paper's TGER indexing cutoff
TIMING_ITERS = 20     # CUDA-event timed calls per kernel measurement
INF = 2**31 - 1


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = TIMING_ITERS, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> int:
    if not torch.equal(a, b):
        raise AssertionError("kernel disagrees with its plain version")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def ea_oracle(np, src, dst, ts, te, n_v, source, window):
    """Vectorised numpy earliest arrival: each round relaxes only the edges
    of the vertices the last round improved."""
    ta, tb = window
    ok = (ts >= ta) & (te <= tb)
    s, d, s_ts, s_te = src[ok], dst[ok], ts[ok], te[ok]
    arr = np.full(n_v, INF, np.int64)
    arr[source] = ta
    frontier = np.zeros(n_v, bool)
    frontier[source] = True
    while frontier.any():
        e = frontier[s] & (arr[s] <= s_ts)
        new = arr.copy()
        np.minimum.at(new, d[e], s_te[e])
        frontier = new < arr
        arr = new
    return arr


def kernel_phases(torch, np, g, plan, window, seed, tem, segments_for):
    """K1 (one window and W=8) and K2 (strict False/True) on random inputs
    at the plan's layout shapes, each against its plain version."""
    dev = g.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lane = plan.layout_perm >= 0
    dst_local = segments_for(plan, g.dst, use_layout=True).tiles.dst_local
    block_tile = plan.layout_block_tile
    ep, nb, nt, tv, be = (lane.shape[0], block_tile.shape[0], plan.n_tiles,
                          plan.tile_v, plan.block_e)
    log(f"layout: {ep} padded slots, {nb} blocks, {nt} tiles of {tv}; "
        f"hub tile 0 owns {int((block_tile == 0).sum())} blocks; "
        f"{nt - int(torch.unique(block_tile).numel())} empty tiles; "
        f"{int((~lane).sum())} padding slots")
    glob = (block_tile.long().repeat_interleave(be) * tv + dst_local.long())

    def rand_cand(shape, p_finite):
        c = torch.randint(0, 100_000, shape, generator=gen, device=dev, dtype=torch.int32)
        keep = torch.rand(shape, generator=gen, device=dev) < p_finite
        return torch.where(keep & lane, c, INF).contiguous()

    rows = []
    # K1, one window
    cand = rand_cand((ep,), 0.1)
    got = tem.segment_min_tiles(dst_local, cand, block_tile, nt, tile_v=tv, block_e=be)
    want = tem.segment_min_tiles_plain(dst_local, cand, block_tile, nt, tile_v=tv, block_e=be)
    err = max_abs_err(torch, got, want)
    lib_out = torch.full((nt * tv,), INF, dtype=torch.int32, device=dev)
    k1 = dict(
        ms=cuda_ms(torch, lambda: tem.segment_min_tiles(
            dst_local, cand, block_tile, nt, tile_v=tv, block_e=be)),
        plain_ms=cuda_ms(torch, lambda: tem.segment_min_tiles_plain(
            dst_local, cand, block_tile, nt, tile_v=tv, block_e=be)),
        library_ms=cuda_ms(torch, lambda: lib_out.scatter_reduce_(
            0, glob, cand, "amin")),
    )
    k1["bound_ms"], k1["bound_by"] = bound_ms(8 * ep + 4 * nb + 4 * nt * tv, 2 * ep)
    log(f"K1 segment_min_tiles [{ep}]: bit-identical; {k1}")

    # K1, W=8 windows in one launch
    W = 8
    cand_w = rand_cand((W, ep), 0.1)
    got = tem.segment_min_tiles(dst_local, cand_w, block_tile, nt, tile_v=tv, block_e=be)
    want = tem.segment_min_tiles_plain(dst_local, cand_w, block_tile, nt, tile_v=tv, block_e=be)
    err = max(err, max_abs_err(torch, got, want))
    glob_w = (glob[None, :] + torch.arange(W, device=dev)[:, None] * nt * tv).reshape(-1)
    lib_w = torch.full((W * nt * tv,), INF, dtype=torch.int32, device=dev)
    flat_w = cand_w.reshape(-1)
    k1w = dict(
        ms=cuda_ms(torch, lambda: tem.segment_min_tiles(
            dst_local, cand_w, block_tile, nt, tile_v=tv, block_e=be)),
        plain_ms=cuda_ms(torch, lambda: tem.segment_min_tiles_plain(
            dst_local, cand_w, block_tile, nt, tile_v=tv, block_e=be)),
        library_ms=cuda_ms(torch, lambda: lib_w.scatter_reduce_(
            0, glob_w, flat_w, "amin")),
    )
    k1w["bound_ms"], k1w["bound_by"] = bound_ms(
        4 * ep + 4 * W * ep + 4 * nb + 4 * W * nt * tv, 2 * W * ep)
    log(f"K1 segment_min_tiles [W={W}, {ep}]: bit-identical; {k1w}")
    rows.append(dict(
        name="segment_min_tiles", route="cuda",
        source="src/repro_torch/kernels/csrc/temporal_edgemap.cu",
        replaces="src/repro/kernels/temporal_edgemap.py:156",
        max_abs_err=err, **k1, windowed_w8=k1w))

    # K2, strict False and True; times at strict=False
    perm = plan.layout_perm
    idx = perm.clamp(min=0).long()
    ts = torch.where(lane, g.t_start[idx], 0).contiguous()
    te = torch.where(lane, g.t_end[idx], 0).contiguous()
    valid = lane.to(torch.int32)
    arr = torch.randint(int(window[0]), int(window[1]) + 1, (ep,), generator=gen,
                        device=dev, dtype=torch.int32)
    arr = torch.where(torch.rand(ep, generator=gen, device=dev) < 0.5, arr, INF).contiguous()
    err2 = 0
    for strict in (False, True):
        got = tem.temporal_relax_min_tiles(dst_local, arr, ts, te, valid, block_tile,
                                           window, nt, tile_v=tv, block_e=be, strict=strict)
        want = tem.temporal_relax_min_tiles_plain(dst_local, arr, ts, te, valid, block_tile,
                                                  window, nt, tile_v=tv, block_e=be,
                                                  strict=strict)
        err2 = max(err2, max_abs_err(torch, got, want))
    cand2 = tem.relax_candidates(arr, ts, te, valid, window, False)
    k2 = dict(
        ms=cuda_ms(torch, lambda: tem.temporal_relax_min_tiles(
            dst_local, arr, ts, te, valid, block_tile, window, nt, tile_v=tv,
            block_e=be)),
        plain_ms=cuda_ms(torch, lambda: tem.temporal_relax_min_tiles_plain(
            dst_local, arr, ts, te, valid, block_tile, window, nt, tile_v=tv,
            block_e=be)),
        library_ms=cuda_ms(torch, lambda: lib_out.scatter_reduce_(
            0, glob, cand2, "amin")),
    )
    k2["bound_ms"], k2["bound_by"] = bound_ms(20 * ep + 4 * nb + 4 * nt * tv, 8 * ep)
    log(f"K2 temporal_relax_min_tiles [{ep}]: bit-identical (strict both); {k2}")
    rows.append(dict(
        name="temporal_relax_min_tiles", route="cuda",
        source="src/repro_torch/kernels/csrc/temporal_edgemap.cu",
        replaces="src/repro/kernels/temporal_edgemap.py:80",
        max_abs_err=err2, **k2,
        library_note="scatter_reduce_ amin over the precomputed candidates "
                     "(the min half of the function)"))
    return rows


def main_path(torch, np, name, g):
    """The port's main path on one graph; returns per-query records."""
    from repro_torch.core import build_tger, plan_query
    from repro_torch.core.algorithms import earliest_arrival
    from repro_torch.device import to_numpy
    from repro_torch.kernels import ops
    from repro_torch.kernels import temporal_edgemap as tem
    from repro_torch.serve import sliding_windows, sweep, sweep_looped

    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    tger = build_tger(g, degree_cutoff=DEGREE_CUTOFF)
    sync()
    log(f"[{name}] build_tger: {time.perf_counter() - t0:.3f} s, "
        f"{tger.n_indexed} indexed vertices, {tger.n_heavy_edges} heavy edges")
    src_np, dst_np = to_numpy(g.src), to_numpy(g.dst)
    ts_np, te_np = to_numpy(g.t_start), to_numpy(g.t_end)
    t_lo, t_hi = int(ts_np.min()), int(te_np.max())
    span = t_hi - t_lo
    windows = {"narrow": (t_hi - span // 50, t_hi), "wide": (t_lo, t_hi)}
    deg = to_numpy(g.out_degree)
    # the top out-degree vertex, and the median source active in the narrow window
    active = np.unique(src_np[ts_np >= windows["narrow"][0]])
    active = active[active != np.argmax(deg)]
    sources = [int(np.argmax(deg)), int(active[len(active) // 2])]
    layout = ops.prepare_layout(g.dst, g.n_vertices)  # the planner's cached copy
    records = []
    for wname, win in windows.items():
        for si, s in enumerate(sources):
            results, times, launches = {}, {}, {}
            for access in ("scan", "index", "hybrid"):
                for backend in ("xla_segment", "pallas_tiled"):
                    plan = plan_query(g, tger, win, access=access, backend=backend)
                    earliest_arrival(g, s, win, tger, plan=plan)  # warm-up
                    sync()
                    before = tem.segment_min_tiles.launches
                    t0 = time.perf_counter()
                    arr = earliest_arrival(g, s, win, tger, plan=plan)
                    sync()
                    times[(access, backend)] = (time.perf_counter() - t0) * 1e3
                    launches[f"{access}/{backend}"] = tem.segment_min_tiles.launches - before
                    results[(access, backend, plan.cache_key)] = arr
            ref = next(iter(results.values()))
            for key, arr in results.items():
                if not torch.equal(arr, ref):
                    raise AssertionError(f"[{name}] {wname} src={s}: {key} differs")
            _, metrics = earliest_arrival(g, s, win, tger, with_metrics=True)
            sync()
            before = tem.temporal_relax_min_tiles.launches
            t0 = time.perf_counter()
            k2 = ops.earliest_arrival_kernel(g, layout, s, win)
            sync()
            k2_ms = (time.perf_counter() - t0) * 1e3
            launches["k2_fixpoint"] = tem.temporal_relax_min_tiles.launches - before
            if not torch.equal(k2, ref):
                raise AssertionError(f"[{name}] {wname} src={s}: K2 fixpoint differs")
            if si == 0:
                want = ea_oracle(np, src_np, dst_np, ts_np, te_np, g.n_vertices, s, win)
                if not (to_numpy(ref).astype(np.int64) == want).all():
                    raise AssertionError(f"[{name}] {wname} src={s}: oracle differs")
            reached = int((ref < INF).sum())
            rounds = metrics.rounds
            log(f"[{name}] {wname} {win} src={s}: {rounds} rounds, {reached} reached; "
                f"plans {sorted({k[2] for k in results})}; "
                + "; ".join(f"{a}/{b} {t:.3f} ms ({t / max(rounds, 1) * 1e3:.1f} us/round)"
                            for (a, b), t in times.items())
                + f"; K2 fixpoint {k2_ms:.3f} ms"
                + ("; oracle agrees" if si == 0 else ""))
            records.append(dict(graph=name, window=wname, source=s, rounds=rounds,
                                reached=reached, k2_ms=k2_ms, launches=launches,
                                ms={f"{a}/{b}": t for (a, b), t in times.items()}))
    # sliding-window sweep on the tiled plan: W=8 windows per K1 launch
    width = span // 50
    wins = sliding_windows(t_hi, width=width, stride=width // 4, count=8)
    s = sources[1]
    tiled = plan_query(g, tger, windows=wins, access="scan", backend="pallas_tiled")
    seg = plan_query(g, tger, windows=wins, access="scan", backend="xla_segment")
    sync()
    t0 = time.perf_counter()
    swept = sweep(g, s, wins, tger, plan=tiled)
    sync()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    looped = sweep_looped(g, s, wins, tger, plan=tiled)
    other = sweep(g, s, wins, tger, plan=seg)
    if not (torch.equal(swept, looped) and torch.equal(swept, other)):
        raise AssertionError(f"[{name}] sweep rows differ")
    log(f"[{name}] sweep W=8 (width {width}) src={s}: {sweep_ms:.3f} ms, rows equal "
        f"to sweep_looped and to the xla_segment sweep; "
        f"{int((swept < INF).sum())} reached in all rows")
    for backend in ("pallas_tiled", "xla_segment"):
        plan = plan_query(g, tger, windows["wide"], access="scan", backend=backend)
        profile_query(torch, f"[{name}] wide src={sources[0]} scan/{backend}",
                      lambda: earliest_arrival(g, sources[0], windows["wide"], tger,
                                                  plan=plan))
    return records


def profile_query(torch, label, fn, top: int = 8) -> None:
    """One query under torch.profiler: device busy time against the host
    wall clock, and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log(f"{label} profile: wall {wall_us:.1f} us, device busy {busy_us:.1f} us "
        f"(idle share {1 - busy_us / wall_us:.3f}), {sum(e.count for e in kernels)} "
        f"kernel launches")
    for e in kernels[:top]:
        log(f"  {e.self_device_time_total:10.1f} us  x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch is missing", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import plan_query
    from repro_torch.data.generators import power_law_temporal_graph, transit_temporal_graph
    from repro_torch.engine.backends import segments_for
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import temporal_edgemap as tem

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.library("temporal_edgemap")
    log(f"build: temporal_edgemap.cu in {time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOG.get("temporal_edgemap", "").splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  nvcc: {line.strip()}")

    graphs = {}
    for name, fn in (("power_law", power_law_temporal_graph),
                     ("transit", transit_temporal_graph)):
        t0 = time.perf_counter()
        graphs[name] = fn(WIKI_TALK_VERTICES, WIKI_TALK_EDGES, seed=args.seed)
        torch.cuda.synchronize()
        log(f"[{name}] graph: {WIKI_TALK_VERTICES} vertices, {WIKI_TALK_EDGES} edges in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        ops.prepare_layout(graphs[name].dst, graphs[name].n_vertices)  # cached for the planner
        torch.cuda.synchronize()
        log(f"[{name}] tile layout: {time.perf_counter() - t0:.3f} s")

    # -- kernel phases at the main path's layout shapes ----------------------
    g = graphs["power_law"]
    t_lo, t_hi = int(g.t_start.min()), int(g.t_end.max())
    plan = plan_query(g, None, (t_lo, t_hi), backend="pallas_tiled")
    rows = kernel_phases(torch, np, g, plan, (t_hi - (t_hi - t_lo) // 50, t_hi),
                         args.seed, tem, segments_for)

    # -- the main path, counted ----------------------------------------------
    tem.reset_launch_counts()
    records = []
    for name, g in graphs.items():
        records += main_path(torch, np, name, g)
    counts = tem.launch_counts()
    log(f"main path launches: {counts}")
    for row in rows:
        row["launches"] = counts[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched on the main path")
    for rec in records:
        log("query " + json.dumps(rec, sort_keys=True))

    print(json.dumps({"kernels": [
        {**r, "kernel_ms": r["ms"]} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
