#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed S]

1. Requires a CUDA card; prints its name and power limit.
2. Builds the kernels of ``src/repro_torch/kernels/csrc`` with nvcc.
3. Kernel phases, at the main path's tile-layout shapes: each kernel
   against its plain PyTorch version on the card (K1/K2 bit-identical, the
   float-sum K3 within rtol/atol 2e-4), timed beside the plain version, one
   PyTorch library call and the memory-bytes bound.
4. The main path at the shape of SNAP's wiki-talk-temporal (1,140,149
   vertices, 7,833,140 temporal edges), generated from ``--seed`` as a
   power-law and a transit graph: build_tger -> plan_query -> earliest
   arrival under {scan, index, hybrid} x {xla_segment, pallas_tiled}, the
   K2 fixpoint and a sliding-window sweep, all bit-identical to each other
   and to a numpy oracle; PageRank (100 iterations) in every plan cell and a
   W=8 sweep against a float64 numpy oracle; BFS, connected components,
   k-core, overlaps reachability and betweenness across both backends (and
   against numpy/scipy oracles for BFS, CC and k-core); profiles of one EA
   and one PageRank query.  The kernels' launch counts are read around it.
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
from concurrent.futures import ThreadPoolExecutor
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
PAGERANK_ITERS = 100  # paper §6.1
# a PageRank view this many times the graph's edges runs fewer iterations
PAGERANK_BIG_VIEW = 8
PAGERANK_BIG_VIEW_ITERS = 10
SPMM_TOL = dict(rtol=2e-4, atol=2e-4)   # the JAX kernel sweep's tolerance
KERNEL_STEMS = ("temporal_edgemap", "segment_spmm")


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


def close_err(torch, got, want, rtol, atol) -> float:
    """Largest |got - want|; raises unless every element is within
    ``atol + rtol * |want|``."""
    diff = (got.double() - want.double()).abs()
    if bool((diff > atol + rtol * want.double().abs()).any()) or bool(diff.isnan().any()):
        raise AssertionError(f"kernel disagrees with its plain version: max |diff| "
                             f"{float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def spmm_phases(torch, np, g, plan, seed, spmm, ops, segments_for):
    """K3 at the power-law layout's shapes, D = 1 (PageRank's message) for
    one window and W = 8, and D = 130 through ``ops.spmm`` on a layout of a
    few thousand edges (the feature-chunk path), each against its plain
    version.  Messages are positive, as PageRank's are."""
    dev = g.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    tiles = segments_for(plan, g.dst, use_layout=True).tiles
    dst_local, lane, block_tile = tiles.dst_local, tiles.lane, plan.layout_block_tile
    ep, nb, nt, tv, be = (lane.shape[0], block_tile.shape[0], plan.n_tiles,
                          plan.tile_v, plan.block_e)
    glob = block_tile.long().repeat_interleave(be) * tv + dst_local.long()
    kw = dict(tile_v=tv, block_e=be)
    out = {}
    for W in (1, 8):
        lead = (W,) if W > 1 else ()
        msgs = torch.rand(lead + (ep, 1), generator=gen, device=dev)
        valid = lane.expand(lead + (ep,)).contiguous()
        got = spmm.segment_spmm_tiles(dst_local, msgs, valid, block_tile, nt, **kw)
        again = spmm.segment_spmm_tiles(dst_local, msgs, valid, block_tile, nt, **kw)
        want = spmm.segment_spmm_tiles_plain(dst_local, msgs, valid, block_tile, nt, **kw)
        err = close_err(torch, got, want, **SPMM_TOL)
        rel_err = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        rerun = float((got - again).abs().max())
        rows = (torch.arange(W, device=dev)[:, None] * nt * tv + glob[None, :]).reshape(-1)
        masked = torch.where(valid[..., None] != 0, msgs, 0.0).reshape(-1, 1)
        lib_out = torch.zeros((W * nt * tv, 1), device=dev)
        rec = dict(
            max_abs_err=err, max_rel_err=rel_err, rerun_max_abs_diff=rerun,
            ms=cuda_ms(torch, lambda: spmm.segment_spmm_tiles(
                dst_local, msgs, valid, block_tile, nt, **kw)),
            plain_ms=cuda_ms(torch, lambda: spmm.segment_spmm_tiles_plain(
                dst_local, msgs, valid, block_tile, nt, **kw)),
            library_ms=cuda_ms(torch, lambda: lib_out.index_add_(0, rows, masked)),
        )
        n_valid = int((valid != 0).sum())
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * ep + 8 * W * ep + 4 * nb + 4 * W * nt * tv, n_valid)
        log(f"K3 segment_spmm_tiles [W={W}, {ep}, D=1]: within rtol/atol 2e-4 "
            f"of plain; {rec}")
        out[W] = rec

    # D = 130 through ops.spmm: 48 KB of shared memory holds 48 float64
    # columns of a 128-slot tile, so D = 130 takes 3 feature chunks on grid z
    n_v, n_e, d = 3000, 6000, 130
    rng = np.random.default_rng(seed)
    dst = torch.as_tensor(rng.integers(0, n_v, n_e).astype(np.int32), device=dev)
    lay = ops.prepare_layout(dst, n_v, tile_v=128, block_e=256)
    msgs = torch.rand((n_e, d), generator=gen, device=dev)
    ok = torch.rand(n_e, generator=gen, device=dev) < 0.7
    before = spmm.segment_spmm_tiles.launches
    got = ops.spmm(lay, dst, msgs, n_vertices=n_v, valid_edges=ok)
    if spmm.segment_spmm_tiles.launches != before + 1:
        raise AssertionError("ops.spmm did not launch K3")
    perm = lay.perm
    in_lay = perm >= 0
    loc = torch.where(in_lay, dst[perm.clamp(min=0).long()], 0) % 128
    msg_g = msgs[perm.clamp(min=0).long()].contiguous()
    valid_g = (in_lay & ok[perm.clamp(min=0).long()]).to(torch.int32)
    args = (loc.to(torch.int32).contiguous(), msg_g, valid_g, lay.block_tile, lay.n_tiles)
    kw = dict(tile_v=128, block_e=256)
    want = spmm.segment_spmm_tiles_plain(*args, **kw)
    err = max(close_err(torch, spmm.segment_spmm_tiles(*args, **kw), want, **SPMM_TOL),
              close_err(torch, got, want.reshape(-1, d)[:n_v], **SPMM_TOL))
    log(f"K3 through ops.spmm [{n_e} edges, {lay.n_edges_padded} slots, D={d}, "
        f"tile_v 128: 3 feature chunks]: within rtol/atol 2e-4 of plain, "
        f"max |diff| {err:.3g}")
    row = dict(name="segment_spmm_tiles", route="cuda",
               source="src/repro_torch/kernels/csrc/segment_spmm.cu",
               replaces="src/repro/kernels/segment_spmm.py:55",
               deterministic=False, **out[1], windowed_w8=out[8],
               ops_spmm_d130_max_abs_err=err)
    row["max_abs_err"] = max(out[1]["max_abs_err"], out[8]["max_abs_err"], err)
    return row


def pagerank_oracle(np, src, dst, ts, te, n_v, window, n_iters, damping=0.85):
    """Vectorised float64 numpy PageRank over the window-valid edges."""
    ok = (ts >= window[0]) & (te <= window[1])
    s, d = src[ok], dst[ok]
    out_deg = np.bincount(s, minlength=n_v).astype(np.float64)
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1.0), 0.0)
    dangling = out_deg == 0
    pr = np.full(n_v, 1.0 / n_v)
    for _ in range(n_iters):
        agg = np.bincount(d, weights=(pr * inv)[s], minlength=n_v)
        pr = (1 - damping) / n_v + damping * (agg + pr[dangling].sum() / n_v)
    return pr


def pagerank_err(np, got, want):
    """(max abs error over max(pr), L1 distance); the ranks sum to 1."""
    diff = np.abs(got.astype(np.float64) - want)
    return float(diff.max() / want.max()), float(diff.sum())


# PageRank tolerance: float32 ranks of the card against the float64
# oracle, the largest error within 1e-5 of the largest rank and an L1
# distance within 1e-4 (ranks sum to 1, so L1 bounds the mass misplaced).
PR_MAX_REL, PR_L1 = 1e-5, 1e-4


def check_pagerank(np, label, got, want, failures):
    """(max |err| / max(pr), L1); a miss is logged and appended to
    ``failures``, which main() raises on after the last phase, so one run
    reports every cell."""
    rel, l1 = pagerank_err(np, got, want)
    if not (rel <= PR_MAX_REL and l1 <= PR_L1):
        failures.append(f"{label}: PageRank off the oracle: max |err| / max(pr) "
                        f"{rel:.3g} (limit {PR_MAX_REL}), L1 {l1:.3g} (limit {PR_L1})")
        log("FAILED " + failures[-1])
    return rel, l1


def pagerank_path(torch, np, name, g, tger, fields, windows, failures):
    """PageRank in every plan cell on both windows, each warm-timed with its
    K3 launches counted and held to the float64 oracle; then a W=8 sweep on
    the tiled plan against ``sweep_looped`` and a profile per backend."""
    from repro_torch.core import plan_query
    from repro_torch.core.algorithms import temporal_pagerank
    from repro_torch.device import to_numpy
    from repro_torch.kernels import segment_spmm as spmm
    from repro_torch.serve import sliding_windows, sweep, sweep_looped

    sync = torch.cuda.synchronize
    src_np, dst_np, ts_np, te_np = fields
    records = []
    for wname, win in windows.items():
        oracles = {}
        for access in ("scan", "index", "hybrid"):
            for backend in ("xla_segment", "pallas_tiled"):
                plan = plan_query(g, tger, win, access=access, backend=backend)
                n_iters = PAGERANK_ITERS
                if plan.method == "hybrid":
                    slots = (int(tger.light_eids.shape[0])
                             + int(tger.indexed_ids.shape[0]) * plan.per_vertex_budget)
                    if slots > PAGERANK_BIG_VIEW * g.n_edges:
                        n_iters = PAGERANK_BIG_VIEW_ITERS
                        log(f"[{name}] pagerank {wname} hybrid: a {slots}-slot view, "
                            f"{slots / g.n_edges:.1f}x the graph; run at {n_iters} "
                            f"iterations instead of {PAGERANK_ITERS}")
                temporal_pagerank(g, win, tger, plan=plan, n_iters=n_iters)  # warm-up
                sync()
                before = spmm.segment_spmm_tiles.launches
                t0 = time.perf_counter()
                pr = temporal_pagerank(g, win, tger, plan=plan, n_iters=n_iters)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                launches = spmm.segment_spmm_tiles.launches - before
                if n_iters not in oracles:
                    oracles[n_iters] = pagerank_oracle(np, src_np, dst_np, ts_np, te_np,
                                                       g.n_vertices, win, n_iters)
                rel, l1 = check_pagerank(np, f"[{name}] {wname} {access}/{backend}",
                                         to_numpy(pr), oracles[n_iters], failures)
                log(f"[{name}] pagerank {wname} {win} {access}/{backend} "
                    f"({plan.cache_key}): {n_iters} iterations, {ms:.3f} ms "
                    f"({ms / n_iters * 1e3:.1f} us/iteration), K3 launches {launches}; "
                    f"oracle: max |err|/max(pr) {rel:.3g}, L1 {l1:.3g}")
                records.append(dict(graph=name, algorithm="pagerank", window=wname,
                                    cell=f"{access}/{backend}", n_iters=n_iters, ms=ms,
                                    k3_launches=launches, max_rel_err=rel, l1=l1))
    t_hi = int(te_np.max())
    width = (t_hi - int(ts_np.min())) // 50
    wins = sliding_windows(t_hi, width=width, stride=width // 4, count=8)
    tiled = plan_query(g, tger, windows=wins, access="scan", backend="pallas_tiled")
    kw = dict(algorithm="pagerank", plan=tiled, n_iters=PAGERANK_ITERS)
    sweep(g, 0, wins, tger, **kw)  # warm-up
    sync()
    before = spmm.segment_spmm_tiles.launches
    t0 = time.perf_counter()
    swept = sweep(g, 0, wins, tger, **kw)
    sync()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    launches = spmm.segment_spmm_tiles.launches - before
    looped = sweep_looped(g, 0, wins, tger, **kw)
    worst = max(check_pagerank(np, f"[{name}] pagerank sweep row {i}",
                               to_numpy(swept[i]), to_numpy(looped[i]).astype(np.float64),
                               failures)[0]
                for i in range(len(wins)))
    rel, l1 = check_pagerank(np, f"[{name}] pagerank sweep row 0", to_numpy(swept[0]),
                             pagerank_oracle(np, src_np, dst_np, ts_np, te_np,
                                             g.n_vertices, tuple(wins[0]), PAGERANK_ITERS),
                             failures)
    log(f"[{name}] pagerank sweep W=8 (width {width}) scan/pallas_tiled: {sweep_ms:.3f} ms "
        f"for {PAGERANK_ITERS} iterations, K3 launches {launches} (one per iteration "
        f"for all 8 windows); rows within tolerance of sweep_looped (max |err|/max(pr) "
        f"{worst:.3g}); row 0 against the oracle {rel:.3g}, L1 {l1:.3g}")
    records.append(dict(graph=name, algorithm="pagerank_sweep_w8", ms=sweep_ms,
                        k3_launches=launches))
    if name == "power_law":
        for backend in ("pallas_tiled", "xla_segment"):
            plan = plan_query(g, tger, windows["wide"], access="scan", backend=backend)
            profile_query(torch, f"[{name}] pagerank wide scan/{backend} "
                                 f"({PAGERANK_ITERS} iterations)",
                          lambda: temporal_pagerank(g, windows["wide"], tger, plan=plan,
                                                    n_iters=PAGERANK_ITERS))
    return records


def bfs_oracle(np, src, dst, ts, te, n_v, source, window):
    """Vectorised numpy min-hop BFS: (hops, arrival)."""
    ok = (ts >= window[0]) & (te <= window[1])
    s, d, s_ts, s_te = src[ok], dst[ok], ts[ok], te[ok]
    arr = np.full(n_v, INF, np.int64)
    hops = np.full(n_v, INF, np.int64)
    arr[source], hops[source] = window[0], 0
    frontier = np.zeros(n_v, bool)
    frontier[source] = True
    rnd = 0
    while frontier.any():
        rnd += 1
        e = frontier[s] & (arr[s] <= s_ts)
        new = arr.copy()
        np.minimum.at(new, d[e], s_te[e])
        frontier = new < arr
        hops[frontier & (hops == INF)] = rnd
        arr = new
    return hops, arr


def cc_oracle(np, src, dst, ts, te, n_v, window):
    """Weak components by scipy, labelled by their smallest vertex."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    ok = (ts >= window[0]) & (te <= window[1])
    adj = coo_matrix((np.ones(int(ok.sum()), np.int8), (src[ok], dst[ok])),
                     shape=(n_v, n_v))
    _, comp = connected_components(adj, directed=True, connection="weak")
    smallest = np.full(comp.max() + 1, n_v, np.int64)
    np.minimum.at(smallest, comp, np.arange(n_v))
    return smallest[comp]


def kcore_oracle(np, src, dst, ts, te, n_v, k, window):
    ok = (ts >= window[0]) & (te <= window[1])
    s, d = src[ok], dst[ok]
    alive = np.ones(n_v, bool)
    while True:
        live = alive[s] & alive[d]
        deg = np.bincount(s[live], minlength=n_v) + np.bincount(d[live], minlength=n_v)
        new = alive & (deg >= k)
        if (new == alive).all():
            return alive
        alive = new


KCORE_K = 4
BETWEENNESS_SOURCES = 4


def analytics_path(torch, np, name, g, tger, fields, window, sources):
    """BFS, CC, k-core, overlaps reachability and betweenness on the narrow
    window, scan x both backends: integer outputs bit-identical across the
    backends, BFS/CC/k-core equal to their oracles, betweenness within
    tolerance across the backends."""
    from repro_torch.core import plan_query
    from repro_torch.core.algorithms import (
        overlaps_reachability,
        temporal_betweenness,
        temporal_bfs,
        temporal_cc,
        temporal_kcore,
    )
    from repro_torch.device import to_numpy
    from repro_torch.kernels import launch_counts

    sync = torch.cuda.synchronize
    src_np, dst_np, ts_np, te_np = fields
    s = sources[0]
    bc_sources = sources[:BETWEENNESS_SOURCES]
    runs = {
        "bfs": lambda plan: temporal_bfs(g, s, window, tger, plan=plan),
        "cc": lambda plan: temporal_cc(g, window, tger, plan=plan),
        "kcore": lambda plan: temporal_kcore(g, KCORE_K, window, tger, plan=plan),
        "reachability": lambda plan: overlaps_reachability(g, s, window, tger, plan=plan),
        "betweenness": lambda plan: temporal_betweenness(g, bc_sources, window, tger,
                                                         plan=plan),
    }
    plans = {b: plan_query(g, tger, window, access="scan", backend=b)
             for b in ("xla_segment", "pallas_tiled")}
    records = []
    for alg, run in runs.items():
        out, ms, k1 = {}, {}, {}
        for backend, plan in plans.items():
            before = launch_counts()["segment_min_tiles"]
            sync()
            t0 = time.perf_counter()
            res = run(plan)
            sync()
            ms[backend] = (time.perf_counter() - t0) * 1e3
            k1[backend] = launch_counts()["segment_min_tiles"] - before
            out[backend] = tuple(to_numpy(r) for r in (res if isinstance(res, tuple)
                                                       else (res,)))
        a, b = out["xla_segment"], out["pallas_tiled"]
        if alg == "betweenness":
            scale = max(float(np.abs(a[0]).max()), 1.0)
            diff = float(np.abs(a[0].astype(np.float64) - b[0]).max())
            if not (np.isfinite(a[0]).all() and diff <= 1e-5 * scale):
                raise AssertionError(f"[{name}] betweenness differs across backends: "
                                     f"{diff} against a max of {scale}")
            note = f"within 1e-5 * max(bc) across backends (max |diff| {diff:.3g})"
        else:
            if not all((x == y).all() for x, y in zip(a, b)):
                raise AssertionError(f"[{name}] {alg} differs across backends")
            note = "bit-identical across backends"
        if alg == "bfs":
            want = bfs_oracle(np, src_np, dst_np, ts_np, te_np, g.n_vertices, s, window)
            if not all((x.astype(np.int64) == y).all() for x, y in zip(a, want)):
                raise AssertionError(f"[{name}] bfs differs from the oracle")
            note += f", oracle agrees ({int((a[0] < INF).sum())} reached)"
        elif alg == "cc":
            if not (a[0] == cc_oracle(np, src_np, dst_np, ts_np, te_np, g.n_vertices,
                                      window)).all():
                raise AssertionError(f"[{name}] cc differs from the oracle")
            note += f", oracle agrees ({len(np.unique(a[0]))} components)"
        elif alg == "kcore":
            if not (a[0] == kcore_oracle(np, src_np, dst_np, ts_np, te_np, g.n_vertices,
                                         KCORE_K, window)).all():
                raise AssertionError(f"[{name}] kcore differs from the oracle")
            note += f", oracle agrees ({int(a[0].sum())} in the {KCORE_K}-core)"
        log(f"[{name}] {alg} narrow {window}: " + "; ".join(
            f"scan/{b} {ms[b]:.3f} ms (K1 launches {k1[b]})" for b in plans) + f"; {note}")
        records.append(dict(graph=name, algorithm=alg, window="narrow", ms=ms,
                            k1_launches=k1))
    return records


def graph_context(torch, np, name, g):
    """The graph's TGER, host copies of its edge fields, the narrow (span/50)
    and wide windows, and the sources: the top out-degree vertex, then
    vertices active in the narrow window at its middle and quartiles."""
    from repro_torch.core import build_tger
    from repro_torch.device import to_numpy

    t0 = time.perf_counter()
    tger = build_tger(g, degree_cutoff=DEGREE_CUTOFF)
    torch.cuda.synchronize()
    log(f"[{name}] build_tger: {time.perf_counter() - t0:.3f} s, "
        f"{tger.n_indexed} indexed vertices, {tger.n_heavy_edges} heavy edges")
    fields = tuple(to_numpy(a) for a in (g.src, g.dst, g.t_start, g.t_end))
    src_np, _, ts_np, te_np = fields
    t_lo, t_hi = int(ts_np.min()), int(te_np.max())
    span = t_hi - t_lo
    windows = {"narrow": (t_hi - span // 50, t_hi), "wide": (t_lo, t_hi)}
    top = int(np.argmax(to_numpy(g.out_degree)))
    active = np.unique(src_np[ts_np >= windows["narrow"][0]])
    active = active[active != top]
    sources = [top] + [int(active[int(len(active) * q)]) for q in (0.5, 0.25, 0.75)]
    return tger, fields, windows, sources


def main_path(torch, np, name, g, tger, fields, windows, sources):
    """Earliest arrival, the port's first main path, on one graph; returns
    per-query records."""
    from repro_torch.core import plan_query
    from repro_torch.core.algorithms import earliest_arrival
    from repro_torch.device import to_numpy
    from repro_torch.kernels import ops
    from repro_torch.kernels import temporal_edgemap as tem
    from repro_torch.serve import sliding_windows, sweep, sweep_looped

    sync = torch.cuda.synchronize
    src_np, dst_np, ts_np, te_np = fields
    t_lo, t_hi = int(ts_np.min()), int(te_np.max())
    span = t_hi - t_lo
    sources = sources[:2]
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
    from repro_torch.kernels import build, launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import segment_spmm as spmm
    from repro_torch.kernels import temporal_edgemap as tem

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_STEMS)) as pool:  # one nvcc per source
        list(pool.map(build.compile_source, KERNEL_STEMS))
    for stem in KERNEL_STEMS:
        build.library(stem)
    log(f"build: {', '.join(s + '.cu' for s in KERNEL_STEMS)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for stem in KERNEL_STEMS:
        for line in build.BUILD_LOG.get(stem, "").splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  nvcc {stem}: {line.strip()}")

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
    rows.append(spmm_phases(torch, np, g, plan, args.seed, spmm, ops, segments_for))

    contexts = {name: graph_context(torch, np, name, g) for name, g in graphs.items()}

    # -- the main path, counted ----------------------------------------------
    reset_launch_counts()
    records, failures = [], []
    for name, g in graphs.items():
        tger, fields, windows, sources = contexts[name]
        records += main_path(torch, np, name, g, tger, fields, windows, sources)
        records += pagerank_path(torch, np, name, g, tger, fields, windows, failures)
        records += analytics_path(torch, np, name, g, tger, fields, windows["narrow"],
                                  sources)
    counts = launch_counts()
    log(f"main path launches: {counts}")
    if failures:
        raise AssertionError(f"{len(failures)} checks failed:\n" + "\n".join(failures))
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
