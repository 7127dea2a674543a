#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed S] [--compare DIR]

1. Requires a CUDA card; prints its name and power limit.
2. Builds the kernels of ``src/repro_torch/kernels/csrc`` with nvcc.
3. Kernel phases, at the main path's tile-layout shapes: each kernel
   against its plain PyTorch version on the card (K1/K2 bit-identical, K1
   also at W = 8 and 32 windows per launch, the
   float-sum K3 within rtol/atol 2e-4), timed beside the plain version, one
   PyTorch library call and the memory-bytes bound; K3 at the power-law and
   the transit layouts.
4. The main path at the shape of SNAP's wiki-talk-temporal (1,140,149
   vertices, 7,833,140 temporal edges), generated from ``--seed`` as a
   power-law and a transit graph: build_tger -> plan_query -> earliest
   arrival under {scan, index, hybrid} x {xla_segment, pallas_tiled}, the
   K2 fixpoint and a sliding-window sweep, all bit-identical to each other
   and to a numpy oracle; PageRank (100 iterations) in every plan cell and a
   W=8 sweep against a float64 numpy oracle; BFS, connected components,
   k-core, overlaps reachability and betweenness across both backends (and
   against numpy/scipy oracles for BFS, CC and k-core); latest departure,
   fastest and shortest duration in every plan cell (against numpy
   oracles) and the one-pass baseline (sound against the EA oracle);
   multi-tenant serving (``serve_batch``: four tenants, 88 rows over four
   sliding windows, a cold start and six advances on a tiled scan plan,
   every row against cold sweeps, K1 and K3 launched inside each advance)
   and an index-ring (transit) and a hybrid-ring (power-law) stream of
   eight advances, each ring against a cold build; profiles of one EA and
   one PageRank query and of one advance of each stream.  The kernels'
   launch counts are read around all of it.
5. The frontier ladder, its launch counts read around it: EA over the
   transit and power-law wide windows from two sources, on scan/
   pallas_tiled and index/xla_segment at ladder caps 0 (dense), 64 and
   4096 (arrival and rounds bit-identical across the caps; warm ms, the
   segment record and the K1 launches of each query); BFS, CC, k-core,
   reachability and betweenness laddered against dense on the narrow
   window; the serving batch with ``ladder=64`` beside the dense chain
   (the cold start laddered, the advances dense, rows and dispatch tags
   equal); an EA loop written with the TemporalEdgeMap primitives (equal
   to ``earliest_arrival``, one K1 launch per round) and its
   ``frontier_trace`` against a numpy oracle; profiles of one laddered and
   one dense EA query on transit wide.  K1 must launch inside laddered
   solves.
6. K4 (flash-decode attention) at phi4-mini-3.8b's decode shape (8 rows,
   2048 positions, ragged lengths, GQA group 3, d_head 128) in bfloat16 and
   float32 against its plain version, timed beside it, beside
   scaled_dot_product_attention and beside its bytes bound: warm (one set of
   caches), and in bfloat16 cold (four sets in turn, past the L2) at those
   lengths and at serving lengths (16-576).  With ``--compare DIR``, the
   kernels of each source present in DIR (``temporal_edgemap.cu``,
   ``segment_spmm.cu``, ``decode_attention.cu``: the kernels before their
   redesign) are built and timed in turns with these (old, new, new, old).
7. LM continuous batching at phi4-mini-3.8b's published widths (32 layers,
   bfloat16, random weights from ``--seed``): a ServeEngine of 8 slots x
   2048 positions serves 16 seeded requests (prompts of 16-512 tokens,
   budgets up to 64, one of 1 and one of 0), with launch counts reset just
   before and read just after (K4 launches = 32 x decode steps); layer 0
   of the engine's own decode steps and every served token are checked
   against ``forward``; prefill and decode times, tokens/s and a profile of
   one decode step are printed.
8. Prints the kernel table as one JSON line (each kernel's launches on
   the counted paths of items 4, 5 and 7, the ladder phase's also apart,
   and K1's launches inside laddered solves), then the result line.

Any mismatch raises, and the script exits non-zero.  It imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
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
SLEEP_CYCLES_PER_S = 2e9  # at least the SM clock (H100 SXM boost 1.98 GHz)
INF = 2**31 - 1
PAGERANK_ITERS = 100  # paper §6.1
# a PageRank view this many times the graph's edges runs fewer iterations
PAGERANK_BIG_VIEW = 8
PAGERANK_BIG_VIEW_ITERS = 10
SPMM_TOL = dict(rtol=2e-4, atol=2e-4)   # the JAX kernel sweep's tolerance
KERNEL_STEMS = ("temporal_edgemap", "segment_spmm", "decode_attention")
# the port's kernels by their names in a profiler trace
PORT_KERNELS = ("segment_min_tiles_kernel", "temporal_relax_min_tiles_kernel",
                "segment_spmm_tiles_kernel", "decode_attention_kernel")
# K4 against its plain version: float32 at the reference kernel's
# tolerance; bfloat16 against the plain version on float32 copies of the
# same inputs, rounded to bfloat16 once, which is the kernel's own
# arithmetic (float32 throughout, the output rounded once): one bfloat16
# ulp (at most 2**-7 of the value) plus float32 summation noise.  The plain
# version on the bfloat16 inputs themselves, which rounds q * scale and the
# probabilities to bfloat16 as the reference's oracle does, is reported.
K4_TOL = {"bfloat16": dict(rtol=2**-7, atol=2**-12),
          "float32": dict(rtol=2e-5, atol=2e-5)}
# scaled_dot_product_attention on the same inputs, a sanity check of the
# library call that is timed: in bfloat16 it rounds the probabilities too
LIBRARY_TOL = {"bfloat16": dict(rtol=2**-6, atol=2**-6),
               "float32": dict(rtol=2e-5, atol=2e-5)}
# LM serving at phi4-mini-3.8b's published widths, 32 layers, bfloat16
LM_ARCH = "phi4-mini-3.8b"
LM_SLOTS, LM_MAX_SEQ = 8, 2048
LM_REQUESTS = 16
LM_PROMPT_LEN = (16, 512)  # <= q_chunk: a longer prompt must be a multiple of it
LM_MAX_NEW = 64
# K4's cold timings rotate through this many sets of bfloat16 caches at the
# decode shape (4 x 67 MB, past the card's 50 MB L2); serving lengths are a
# prompt of LM_PROMPT_LEN plus up to LM_MAX_NEW new tokens
K4_SETS = 4
K4_SERVING_LENGTHS = (LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + LM_MAX_NEW)
# Checks of the served tokens (``check_served_tokens``).  The reference's
# init (normal / sqrt(shape[-2]): wq scales by 1/sqrt(H), not 1/sqrt(d))
# gives attention scores a spread of ~220 at these widths, so the softmax is
# nearly one-hot and a rounding-level change of q moves it; over 32 layers
# two correct implementations decorrelate, in float32 as in bfloat16 (the
# reference's own float32 logits move by more than 5e-2 after ten layers
# when every embedding moves by one ulp: tests/test_torch_lm.py).  So the
# served tokens are checked where that amplification has no room:
# - the engine's own state, at layer 0 of every decode step of the served
#   run (``check_engine_state``): for every request, the layer-0 K/V rows
#   of its slot, prompt and decoded positions, each within LM_KV_TOL of
#   forward's over the same tokens, and the engine's layer-0 output at every
#   decoded position against layer 0's decode block fed forward's K/V: the
#   median within LM_KV_TOL and each within LM_STATE_H_MAX (last-bit
#   differences of K move near-tied scores; a wrong slot, length or
#   position reads unrelated rows and gives ~1);
# - the first token of each request, from prefill, against ``forward`` over
#   the prompt alone (the same blocks at the same length; only the head's
#   matmul differs): within LM_LOGIT_TOL of the row's largest logit, a
#   few bfloat16 roundings at |logit| ~ 4-8, and the argmax for at least
#   LM_ARGMAX_MIN of them;
# - every layer of the decode step, teacher-forced: each request's last
#   decode position, the block's input taken from ``forward`` over the
#   prompt and the generated prefix and its cache from forward's K/V, the
#   decode block's output and written K/V against forward's (relative L2).
#   In float32, on the served weights widened (LM_F32_REQUESTS requests),
#   every block within LM_LAYER_TOL.  In bfloat16, on the served model, the
#   written K/V and the median block within LM_LAYER_TOL, and every block
#   within it when K4's plain version takes K4's place: that version rounds
#   q * scale and the probabilities to bfloat16 as forward's attention
#   does, K4 keeps them in float32 and moves near-tied scores, so K4's
#   largest block errors are reported beside it, not required;
# - end to end, each generated token's logit in ``forward`` over prompt and
#   prefix is reported (argmax share, gap to the row's max), not required.
LM_LOGIT_TOL = 0.25
LM_ARGMAX_MIN = 0.9
LM_LAYER_TOL = {"bfloat16": 2**-6, "float32": 1e-4}
LM_KV_TOL = 2**-7
LM_STATE_H_MAX = 0.25
LM_F32_REQUESTS = 4


def ptxas_report(text: str):
    """(kernel instance, "registers; spills; shared memory") for each entry
    function in nvcc's -Xptxas -v output; template arguments as
    <type, ints...> from the mangled name."""
    import re

    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"([a-z_]+_kernel)", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            dtype = ("bf16" if "__nv_bfloat16" in mangled else
                     "f32" if re.search(r"_kernelIf", mangled) else None)
            name = (base.group(1) if base else mangled) + (
                f"<{', '.join(([dtype] if dtype else []) + args)}>" if args else "")
        elif "spill" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append((name, line.split(":", 1)[1].strip() + "; " + spill))
            name, spill = None, ""
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compare", metavar="DIR",
                   help="also time the kernels built from DIR/temporal_edgemap.cu (K1, "
                        "K2), DIR/segment_spmm.cu (K3) and DIR/decode_attention.cu (K4), "
                        "whichever are present: their sources before the redesign (C "
                        "entry points as PARENT_SIGNATURES), in turns with these")
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = TIMING_ITERS, warmup: int = 3,
            prefill: bool = True) -> float:
    """Mean device milliseconds per call, from CUDA events around ``iters``
    calls.  With ``prefill`` the calls are queued behind a sleep kernel that
    outlasts their enqueue (twice the host time of the fastest warm-up call
    per call), so the events time the device running them back to back and
    not the host's launch overhead; without it a fast kernel's time is
    paced by its host overhead."""
    host_s = float("inf")
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_s = min(host_s, time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if prefill:
        torch.cuda._sleep(int(max(2 * iters * host_s, 1e-3) * SLEEP_CYCLES_PER_S))
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


def timed_pair(torch, new, old=None):
    """(ms of ``new``, ms of ``old``, the four times): with ``old``, both
    are timed in turns old, new, new, old, and each time is the mean of its
    two turns; without it, ``new`` alone and (ms, None, None)."""
    if old is None:
        return cuda_ms(torch, new), None, None
    turns = [cuda_ms(torch, old), cuda_ms(torch, new), cuda_ms(torch, new),
             cuda_ms(torch, old)]
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2, turns


def rotating(fn, sets):
    """A function that calls ``fn(*set)`` on the next of ``sets`` each time:
    each call finds its inputs out of L2 when the sets together exceed it."""
    calls = itertools.count()
    return lambda: fn(*sets[next(calls) % len(sets)])


# ``--compare DIR``: kernels as they were before their redesign, built
# from DIR/<stem>.cu (not in the repository) for each stem present there,
# timed in turns with this checkout's kernels.  Their C entry points, as
# (pointers, ints) before the stream, and for K4 the count of ints after
# its float: K1 and K2 min into an INT_MAX-filled output; K3 adds into a
# zero-filled float64 output, rounded to float32 afterwards; K4 takes
# float32 partial scratch for ceil(S / 128) splits.
PARENT_SIGNATURES = {
    "temporal_edgemap": {"segment_min_tiles_launch": (4, 5),
                         "temporal_relax_min_tiles_launch": (7, 7)},
    "segment_spmm": {"segment_spmm_tiles_launch": (5, 6)},
    "decode_attention": {"decode_attention_launch": (6, 6, 2)},
}
PARENT_K4_CHUNK = 128


def build_parent(src_dir):
    """Compile each earlier source present in ``src_dir`` with the
    checkout's nvcc flags, in parallel, and bind its entry points; returns
    entry point name -> function."""
    import ctypes

    from repro_torch.kernels import build

    P, I = ctypes.c_void_p, ctypes.c_int
    stems = [s for s in PARENT_SIGNATURES if (Path(src_dir) / f"{s}.cu").is_file()]
    if not stems:
        raise RuntimeError(f"--compare {src_dir}: none of "
                           f"{', '.join(s + '.cu' for s in PARENT_SIGNATURES)} there")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def compile_one(stem):
        lib_path = build.BUILD_DIR / f"parent-{stem}.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                               str(Path(src_dir) / f"{stem}.cu")],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the earlier {stem}.cu:\n{proc.stderr}")
        return lib_path

    with ThreadPoolExecutor(len(stems)) as pool:
        paths = dict(zip(stems, pool.map(compile_one, stems)))
    fns = {}
    for stem, lib_path in paths.items():
        lib = ctypes.CDLL(str(lib_path))
        for fn, (n_ptr, n_int, *rest) in PARENT_SIGNATURES[stem].items():
            f = getattr(lib, fn)
            f.argtypes = ([P] * n_ptr + [I] * n_int
                          + ([ctypes.c_float] + [I] * rest[0] if rest else []) + [P])
            f.restype = I
            fns[fn] = f
    log(f"--compare: built {', '.join(s + '.cu' for s in stems)} from {src_dir}")
    return fns


def parent_for(parent, fn):
    """``parent`` where it holds the earlier ``fn``, else None."""
    return parent if parent and fn in parent else None


def parent_k1(torch, parent, dst_local, cand, block_tile, nt, *, tile_v, block_e):
    w = cand.shape[0] if cand.dim() == 2 else 1
    out = torch.full((w, nt, tile_v), INF, dtype=torch.int32, device=cand.device)
    rc = parent["segment_min_tiles_launch"](
        dst_local.data_ptr(), cand.data_ptr(), block_tile.data_ptr(), out.data_ptr(),
        block_tile.shape[0], nt, tile_v, block_e, w, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier K1: launch failed (cudaError {rc})")
    return out if cand.dim() == 2 else out[0]


def parent_k2(torch, parent, dst_local, arr, ts, te, valid, block_tile, window, nt, *,
              tile_v, block_e, strict=False):
    out = torch.full((nt, tile_v), INF, dtype=torch.int32, device=arr.device)
    rc = parent["temporal_relax_min_tiles_launch"](
        dst_local.data_ptr(), arr.data_ptr(), ts.data_ptr(), te.data_ptr(),
        valid.data_ptr(), block_tile.data_ptr(), out.data_ptr(), block_tile.shape[0], nt,
        tile_v, block_e, int(window[0]), int(window[1]), int(strict),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier K2: launch failed (cudaError {rc})")
    return out


def parent_k3(torch, parent, dst_local, msgs, valid, block_tile, nt, *, tile_v, block_e):
    w = msgs.shape[0] if msgs.dim() == 3 else 1
    out = torch.zeros((w, nt, tile_v, msgs.shape[-1]), dtype=torch.float64,
                      device=msgs.device)
    rc = parent["segment_spmm_tiles_launch"](
        dst_local.data_ptr(), msgs.data_ptr(), valid.data_ptr(), block_tile.data_ptr(),
        out.data_ptr(), block_tile.shape[0], nt, tile_v, block_e, msgs.shape[-1], w,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier K3: launch failed (cudaError {rc})")
    out = out.to(torch.float32)
    return out if msgs.dim() == 3 else out[0]


def parent_k4(torch, parent, q, k, v, lens):
    import ctypes
    import math

    B, H, Dh = q.shape
    S, KH = k.shape[1], k.shape[2]
    part = torch.empty((B, KH, -(-S // PARENT_K4_CHUNK), H // KH, Dh + 2),
                       dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = parent["decode_attention_launch"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), part.data_ptr(),
        out.data_ptr(), B, S, KH, H // KH, Dh, PARENT_K4_CHUNK,
        ctypes.c_float(1.0 / math.sqrt(Dh)), int(q.dtype == torch.bfloat16),
        16 // q.element_size(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier K4: launch failed (cudaError {rc})")
    return out


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


def kernel_phases(torch, np, g, plan, window, seed, tem, segments_for, parent=None):
    """K1 (W = 1, 8 and 32 windows per launch) and K2 (strict False/True)
    on random inputs at the plan's layout shapes, each against its plain
    version, and with ``parent`` (``--compare``) timed in turns with the
    kernels before their redesign."""
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
    kw = dict(tile_v=tv, block_e=be)

    def rand_cand(shape, p_finite):
        c = torch.randint(0, 100_000, shape, generator=gen, device=dev, dtype=torch.int32)
        keep = torch.rand(shape, generator=gen, device=dev) < p_finite
        return torch.where(keep & lane, c, INF).contiguous()

    rows = []
    # K1 at one window and at W windows per launch: W=8 (the sweeps) and
    # W=32 (fastest's departure ladder, the serving path's EA group); the
    # slow plain and library calls at W=32 are timed over fewer calls
    err, k1 = 0, {}
    for W, iters in ((1, TIMING_ITERS), (8, TIMING_ITERS), (32, 5)):
        cand = rand_cand((W, ep) if W > 1 else (ep,), 0.1)
        args = (dst_local, cand, block_tile, nt)
        want = tem.segment_min_tiles_plain(*args, **kw)
        err = max(err, max_abs_err(torch, tem.segment_min_tiles(*args, **kw), want))
        old = None
        if parent:
            max_abs_err(torch, parent_k1(torch, parent, *args, **kw), want)
            old = lambda: parent_k1(torch, parent, *args, **kw)  # noqa: E731
        del want
        glob_w = (glob[None, :] + torch.arange(W, device=dev)[:, None] * nt * tv).reshape(-1)
        lib_w = torch.full((W * nt * tv,), INF, dtype=torch.int32, device=dev)
        flat_w = cand.reshape(-1)
        ms, parent_ms, turns = timed_pair(
            torch, lambda: tem.segment_min_tiles(*args, **kw), old)
        rec = dict(
            ms=ms,
            plain_ms=cuda_ms(torch, lambda: tem.segment_min_tiles_plain(*args, **kw),
                             iters=iters),
            library_ms=cuda_ms(torch, lambda: lib_w.scatter_reduce_(
                0, glob_w, flat_w, "amin"), iters=iters),
        )
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * ep + 4 * W * ep + 4 * nb + 4 * W * nt * tv, 2 * W * ep)
        rec["bound_share"] = rec["bound_ms"] / ms
        if parent:
            rec.update(parent_ms=parent_ms, ab_turns_ms=turns,
                       parent_bound_share=rec["bound_ms"] / parent_ms)
        log(f"K1 segment_min_tiles [W={W}, {ep}]: bit-identical; {rec}")
        if W == 1:
            k1 = rec
        else:
            k1[f"windowed_w{W}"] = rec
        del cand, args, glob_w, lib_w, flat_w
    rows.append(dict(
        name="segment_min_tiles", route="cuda",
        source="src/repro_torch/kernels/csrc/temporal_edgemap.cu",
        replaces="src/repro/kernels/temporal_edgemap.py:156",
        max_abs_err=err, **k1))

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
    args2 = (dst_local, arr, ts, te, valid, block_tile, window, nt)
    for strict in (False, True):
        want = tem.temporal_relax_min_tiles_plain(*args2, **kw, strict=strict)
        err2 = max(err2, max_abs_err(
            torch, tem.temporal_relax_min_tiles(*args2, **kw, strict=strict), want))
        if parent:
            max_abs_err(torch, parent_k2(torch, parent, *args2, **kw, strict=strict), want)
    cand2 = tem.relax_candidates(arr, ts, te, valid, window, False)
    lib_out = torch.full((nt * tv,), INF, dtype=torch.int32, device=dev)
    ms, parent_ms, turns = timed_pair(
        torch, lambda: tem.temporal_relax_min_tiles(*args2, **kw),
        (lambda: parent_k2(torch, parent, *args2, **kw)) if parent else None)
    k2 = dict(
        ms=ms,
        plain_ms=cuda_ms(torch, lambda: tem.temporal_relax_min_tiles_plain(*args2, **kw)),
        library_ms=cuda_ms(torch, lambda: lib_out.scatter_reduce_(
            0, glob, cand2, "amin")),
    )
    k2["bound_ms"], k2["bound_by"] = bound_ms(20 * ep + 4 * nb + 4 * nt * tv, 8 * ep)
    k2["bound_share"] = k2["bound_ms"] / ms
    if parent:
        k2.update(parent_ms=parent_ms, ab_turns_ms=turns,
                  parent_bound_share=k2["bound_ms"] / parent_ms)
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


def spmm_layout_timings(torch, name, g, plan, gen, spmm, segments_for, parent):
    """K3 at one graph's tile layout, D = 1 (PageRank's message), for one
    window and W = 8, each against its plain version and timed beside it,
    beside ``index_add_`` and (with ``parent``) beside the kernel before its
    redesign, in turns.  Messages are positive, as PageRank's are."""
    dev = g.device
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
        args = (dst_local, msgs, valid, block_tile, nt)
        got = spmm.segment_spmm_tiles(*args, **kw)
        again = spmm.segment_spmm_tiles(*args, **kw)
        want = spmm.segment_spmm_tiles_plain(*args, **kw)
        err = close_err(torch, got, want, **SPMM_TOL)
        rel_err = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        rerun = float((got - again).abs().max())
        rows = (torch.arange(W, device=dev)[:, None] * nt * tv + glob[None, :]).reshape(-1)
        masked = torch.where(valid[..., None] != 0, msgs, 0.0).reshape(-1, 1)
        lib_out = torch.zeros((W * nt * tv, 1), device=dev)
        old = None
        if parent:
            close_err(torch, parent_k3(torch, parent, *args, **kw), want, **SPMM_TOL)
            old = lambda: parent_k3(torch, parent, *args, **kw)  # noqa: E731
        ms, parent_ms, turns = timed_pair(
            torch, lambda: spmm.segment_spmm_tiles(*args, **kw), old)
        rec = dict(
            max_abs_err=err, max_rel_err=rel_err, rerun_max_abs_diff=rerun, ms=ms,
            plain_ms=cuda_ms(torch, lambda: spmm.segment_spmm_tiles_plain(*args, **kw)),
            library_ms=cuda_ms(torch, lambda: lib_out.index_add_(0, rows, masked)),
        )
        if parent:
            rec.update(parent_ms=parent_ms, ab_turns_ms=turns)
        n_valid = int((valid != 0).sum())
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * ep + 8 * W * ep + 4 * nb + 4 * W * nt * tv, n_valid)
        log(f"K3 segment_spmm_tiles [{name}, W={W}, {ep}, D=1]: within rtol/atol 2e-4 "
            f"of plain; {rec}")
        out[W] = rec
    return out


def spmm_phases(torch, np, layouts, seed, spmm, ops, segments_for, parent=None):
    """K3 at the power-law and the transit layouts (``layouts``: name ->
    (graph, tiled plan)), and D = 130 through ``ops.spmm`` on a layout of a
    few thousand edges (the feature-chunk path), each against its plain
    version."""
    dev = layouts["power_law"][0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    timings = {name: spmm_layout_timings(torch, name, g, plan, gen, spmm, segments_for,
                                         parent)
               for name, (g, plan) in layouts.items()}

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
    pl = timings["power_law"]
    row = dict(name="segment_spmm_tiles", route="cuda",
               source="src/repro_torch/kernels/csrc/segment_spmm.cu",
               replaces="src/repro/kernels/segment_spmm.py:55",
               deterministic=False, **pl[1], windowed_w8=pl[8],
               transit=dict(w1=timings["transit"][1], w8=timings["transit"][8]),
               ops_spmm_d130_max_abs_err=err)
    row["max_abs_err"] = max([err] + [t[w]["max_abs_err"] for t in timings.values()
                                      for w in (1, 8)])
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


INT_NEG_INF = -(2**31)
SD_BUCKETS = 64        # shortest_duration's staircase (the reference's default)
ONEPASS_CHUNK = 4096   # earliest_arrival_onepass's defaults
ONEPASS_ITERS = 2
SERVE_WINDOWS = 4      # sliding windows per serving tenant
SERVE_ADVANCES = 6
SERVE_EA_SOURCES = 8
SERVE_BFS_SOURCES = 4
SERVE_PAGERANK_ITERS = 20
RING_ADVANCES = 8
RING_SOURCES = 2
CELLS = [(a, b) for a in ("scan", "index", "hybrid")
         for b in ("xla_segment", "pallas_tiled")]


def ld_oracle(np, src, dst, ts, te, n_v, target, window):
    """Vectorised numpy latest departure (succeeds): each round relaxes the
    in-edges of the vertices the last round improved, max into the source."""
    ta, tb = window
    ok = (ts >= ta) & (te <= tb)
    s, d, s_ts, s_te = src[ok], dst[ok], ts[ok], te[ok]
    ld = np.full(n_v, INT_NEG_INF, np.int64)
    ld[target] = tb
    frontier = np.zeros(n_v, bool)
    frontier[target] = True
    while frontier.any():
        e = frontier[d] & (s_te <= ld[d])
        new = ld.copy()
        np.maximum.at(new, s[e], s_ts[e])
        frontier = new > ld
        ld = new
    return ld


def sd_oracle(np, src, dst, ts, te, n_v, source, window, n_buckets):
    """Numpy shortest duration over the same bucketed Pareto staircase:
    dur[v, p] = least summed duration of a path arriving by bound[p], the
    bounds a float32 grid over the window (``x * float32(1 / P)``, as the
    compiled reference rounds it); float32 sums, so equal bit for bit."""
    ta, tb = window
    P = n_buckets
    steps = np.arange(1, P + 1, dtype=np.int32).astype(np.float32)
    bounds = ta + (np.float32(tb - ta) * steps * (np.float32(1) / np.float32(P))
                   ).astype(np.int32)
    ok = (ts >= ta) & (te <= tb)
    s, d, s_ts, s_te = src[ok], dst[ok], ts[ok], te[ok]
    cost = (s_te - s_ts).astype(np.float32)
    q = np.minimum(np.searchsorted(bounds, s_te, side="left"), P - 1)
    p_src = np.searchsorted(bounds, s_ts, side="right") - 1
    from_source = s == source
    usable_src = (p_src >= 0) | from_source
    p_c = np.maximum(p_src, 0)
    flat = d.astype(np.int64) * P + q
    dur = np.full((n_v, P), np.inf, np.float32)
    dur[source] = 0
    frontier = np.zeros(n_v, bool)
    frontier[source] = True
    while frontier.any():
        use = frontier[s] & usable_src
        cand = np.where(from_source, np.float32(0), dur[s, p_c]) + cost
        upd = np.full(n_v * P, np.inf, np.float32)
        np.minimum.at(upd, flat[use], cand[use])
        new = np.minimum.accumulate(np.minimum(dur, upd.reshape(n_v, P)), axis=1)
        frontier = (new < dur).any(axis=1)
        dur = new
    return dur[:, P - 1]


def departures(np, g_fields, offsets, v, window, n_departures=32):
    """The distinct start times of v's first ``n_departures`` out-edges
    starting inside the window (its T-CSR slice is start-sorted)."""
    ts = g_fields[2]
    sl = ts[offsets[v]:offsets[v + 1]]
    sl = sl[(sl >= window[0]) & (sl <= window[1])][:n_departures]
    return np.unique(sl)


def fastest_oracle(np, fields, n_v, source, window, departs):
    """min over departures d of ea_oracle([d, tb]) - d; 0 at the source."""
    best = np.full(n_v, INF, np.int64)
    for d in departs:
        arr = ea_oracle(np, *fields, n_v, source, (int(d), window[1]))
        best = np.minimum(best, np.where(arr == INF, INF, arr - d))
    best[source] = 0
    return best


def paths_path(torch, np, name, g, tger, fields, windows, sources):
    """Latest departure, fastest and shortest duration (the rest of
    ``paths.py``) in the six plan cells on the narrow window, bit-identical
    across cells and equal to numpy oracles; on power_law latest departure
    and fastest on the wide window too (scan cells).  Then the one-pass
    baseline, held sound against the EA oracle."""
    from repro_torch.core import plan_query
    from repro_torch.core.algorithms import fastest, latest_departure, shortest_duration
    from repro_torch.core.onepass import earliest_arrival_onepass
    from repro_torch.device import to_numpy
    from repro_torch.kernels import launch_counts

    sync = torch.cuda.synchronize
    src_np, dst_np, ts_np, te_np = fields
    n_v = g.n_vertices
    offsets = to_numpy(g.out_offsets)
    in_deg = np.bincount(dst_np, minlength=n_v)
    target = int(np.argmax(in_deg))
    s = sources[0]
    runs = {
        "latest_departure": lambda win, plan: latest_departure(g, target, win, tger,
                                                               plan=plan),
        "fastest": lambda win, plan: fastest(g, s, win, tger, plan=plan),
        "shortest_duration": lambda win, plan: shortest_duration(
            g, s, win, tger, plan=plan, n_buckets=SD_BUCKETS),
    }
    cells = {"narrow": CELLS}
    if name == "power_law":
        cells["wide"] = [("scan", "xla_segment"), ("scan", "pallas_tiled")]
    records = []
    for wname, cell_list in cells.items():
        win = windows[wname]
        for alg, run in runs.items():
            if wname == "wide" and alg == "shortest_duration":
                continue
            out, ms, k1 = {}, {}, {}
            for access, backend in cell_list:
                plan = plan_query(g, tger, win, access=access, backend=backend)
                before = launch_counts()["segment_min_tiles"]
                sync()
                t0 = time.perf_counter()
                res = run(win, plan)
                sync()
                ms[f"{access}/{backend}"] = (time.perf_counter() - t0) * 1e3
                k1[f"{access}/{backend}"] = launch_counts()["segment_min_tiles"] - before
                out[f"{access}/{backend}"] = res
            ref = next(iter(out.values()))
            for cell, res in out.items():
                if not torch.equal(res, ref):
                    raise AssertionError(f"[{name}] {alg} {wname}: {cell} differs")
            note = "bit-identical across cells"
            host = to_numpy(ref)
            if wname == "narrow" and alg == "latest_departure":
                want = ld_oracle(np, *fields, n_v, target, win)
                if not (host.astype(np.int64) == want).all():
                    raise AssertionError(f"[{name}] latest_departure differs from the oracle")
                note += f", oracle agrees ({int((host > INT_NEG_INF).sum())} can reach " \
                        f"{target})"
            elif wname == "narrow" and alg == "shortest_duration":
                want = sd_oracle(np, *fields, n_v, s, win, SD_BUCKETS)
                if not (host.view(np.int32) == want.view(np.int32)).all():
                    raise AssertionError(f"[{name}] shortest_duration differs from the "
                                         f"oracle")
                note += f", oracle agrees bit for bit ({int(np.isfinite(host).sum())} " \
                        f"reached)"
            log(f"[{name}] {alg} {wname} {win}: " + "; ".join(
                f"{c} {t:.3f} ms (K1 {k1[c]})" for c, t in ms.items()) + f"; {note}")
            records.append(dict(graph=name, algorithm=alg, window=wname, ms=ms,
                                k1_launches=k1))
    # fastest against the oracle from a source with a few distinct departures,
    # after a profile of the narrow query (its ladders run K1 at W = 32)
    win = windows["narrow"]
    plan = plan_query(g, tger, win, access="scan", backend="pallas_tiled")
    profile_query(torch, f"[{name}] fastest narrow src={s} scan/pallas_tiled",
                  lambda: fastest(g, s, win, tger, plan=plan))
    active = np.unique(src_np[(ts_np >= win[0]) & (ts_np <= win[1])])
    fsrc = next(int(v) for v in active[np.argsort(-np.diff(offsets)[active])]
                if 2 <= len(departures(np, fields, offsets, v, win)) <= 6)
    deps = departures(np, fields, offsets, fsrc, win)
    got = to_numpy(fastest(g, fsrc, win, tger, plan=plan)).astype(np.int64)
    if not (got == fastest_oracle(np, fields, n_v, fsrc, win, deps)).all():
        raise AssertionError(f"[{name}] fastest differs from its oracle")
    log(f"[{name}] fastest narrow src={fsrc} ({len(deps)} departures): equal to the "
        f"minimum over departures of the EA oracle ({int((got < INF).sum())} reached)")
    # the one-pass baseline: sound (never earlier than the fixpoint)
    sync()
    t0 = time.perf_counter()
    one = earliest_arrival_onepass(g, tger, s, win, chunk_size=ONEPASS_CHUNK,
                                   intra_chunk_iters=ONEPASS_ITERS)
    sync()
    one_ms = (time.perf_counter() - t0) * 1e3
    one = to_numpy(one).astype(np.int64)
    want = ea_oracle(np, *fields, n_v, s, win)
    if (one < want).any():
        raise AssertionError(f"[{name}] onepass reports an arrival earlier than EA")
    later = int((one > want).sum())
    log(f"[{name}] earliest_arrival_onepass narrow src={s}: {one_ms:.3f} ms "
        f"({-(-g.n_edges // ONEPASS_CHUNK)} chunks x {ONEPASS_ITERS}); sound, later than "
        f"the fixpoint at {later} of {int((want < INF).sum())} reached vertices")
    records.append(dict(graph=name, algorithm="onepass", window="narrow", ms=one_ms,
                        later_vertices=later))
    return records


def _batch_rows_vs_cold(torch, np, name, g, tger, batch, results, plan, failures, step):
    """Each group's rows against cold sweeps of that group under ``plan``:
    integer groups bit for bit, PageRank within the PageRank phase's
    tolerance."""
    from repro_torch.device import to_numpy
    from repro_torch.serve import sweep

    for gi, ((alg, params), rows) in enumerate(batch.groups().items()):
        wins = sorted({r.window for r in rows})
        col = {w: i for i, w in enumerate(wins)}
        cold = {}
        for src in {r.source for r in rows}:
            cold[src] = sweep(g, 0 if src is None else src, np.asarray(wins, np.int32),
                              tger, algorithm=alg, plan=plan, **dict(params))
        res = results[gi]
        for qi, r in enumerate(rows):
            want = cold[r.source]
            if alg == "pagerank":
                check_pagerank(np, f"[{name}] serving advance {step} pagerank row {qi}",
                               to_numpy(res[qi]),
                               to_numpy(want[col[r.window]]).astype(np.float64), failures)
                continue
            parts = zip(res, want) if isinstance(res, tuple) else ((res, want),)
            for a, b in parts:
                if not torch.equal(a[qi], b[col[r.window]]):
                    raise AssertionError(f"[{name}] serving advance {step}: {alg} row {qi} "
                                         f"differs from the cold sweep")


def serving_stream(np, fields):
    """The serving phases' tenant stream: ``batch_at(base)`` is the batch of
    four tenants over SERVE_WINDOWS sliding windows ending at ``base`` (EA
    from 8 sources, the same EA rows again, BFS from 4 sources, CC and
    PageRank); returns it with the cold start's base and the stride."""
    from repro_torch.engine import QueryBatch, QuerySpec
    from repro_torch.serve import sliding_windows

    src_np, _, ts_np, te_np = fields
    t_hi = int(te_np.max())
    width = (t_hi - int(ts_np.min())) // 50
    stride = width // 4
    active = np.unique(src_np[ts_np >= t_hi - width])
    ea_src = [int(active[int(len(active) * q)]) for q in
              np.linspace(0, 1, SERVE_EA_SOURCES, endpoint=False)]
    bfs_src = ea_src[:SERVE_BFS_SOURCES]

    def batch_at(base):
        wins = [tuple(int(x) for x in w) for w in
                sliding_windows(base, width, stride, SERVE_WINDOWS)]
        specs = []
        for _tenant in range(2):   # two tenants asking the same EA rows
            specs += [QuerySpec.make("earliest_arrival", w, sources=ea_src) for w in wins]
        specs += [QuerySpec.make("bfs", w, sources=bfs_src) for w in wins]
        specs += [QuerySpec.make("cc", w) for w in wins]
        specs += [QuerySpec.make("pagerank", w, n_iters=SERVE_PAGERANK_ITERS) for w in wins]
        return QueryBatch.make(specs)

    return batch_at, t_hi - (SERVE_ADVANCES + 1) * stride, stride


def serving_path(torch, np, name, g, tger, fields, failures):
    """Multi-tenant serving (``serve_batch``) on a scan/pallas_tiled plan:
    the ``serving_stream`` tenants, a cold start and SERVE_ADVANCES
    advances, each checked against cold sweeps, with its time, rows solved
    and K1/K3 launches; then one advance profiled."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import dispatch_log, serve_batch

    sync = torch.cuda.synchronize
    batch_at, base, stride = serving_stream(np, fields)
    # rows that a one-stride slide adds: one new window per spec family
    new_rows = 2 * SERVE_EA_SOURCES + SERVE_BFS_SOURCES + 2
    new_unique = SERVE_EA_SOURCES + SERVE_BFS_SOURCES + 2
    state, records = None, []
    for step in range(SERVE_ADVANCES + 1):
        batch = batch_at(base + step * stride)
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        with dispatch_log() as tags:
            results, state = serve_batch(g, batch, tger, state=state, access="scan",
                                         backend="pallas_tiled")
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        k1 = after["segment_min_tiles"] - before["segment_min_tiles"]
        k3 = after["segment_spmm_tiles"] - before["segment_spmm_tiles"]
        if step == 0:   # the second tenant's EA rows dedup
            want = ("cold", batch.n_rows, batch.n_rows - SERVE_EA_SOURCES * SERVE_WINDOWS)
        else:
            want = ("reuse", new_rows, new_unique)
            if tags != ["fused:scan"]:
                raise AssertionError(f"[{name}] serving advance {step} logged {tags}")
        got = (state.last_advance, state.n_solved, state.n_solved_unique)
        if got != want:
            raise AssertionError(f"[{name}] serving advance {step}: (last_advance, "
                                 f"n_solved, n_solved_unique) {got}, expected {want}")
        if k1 <= 0 or k3 <= 0:
            raise AssertionError(f"[{name}] serving advance {step}: K1 {k1}, K3 {k3} "
                                 f"launches")
        _batch_rows_vs_cold(torch, np, name, g, tger, batch, results, state.plan,
                            failures, step)
        log(f"[{name}] serving {state.last_advance} {step}: {ms:.3f} ms, "
            f"{state.n_solved} rows solved ({state.n_solved_unique} unique) of "
            f"{batch.n_rows}, K1 {k1} / K3 {k3} launches, EA rounds {state.last_rounds}; "
            f"rows equal to cold sweeps")
        records.append(dict(graph=name, algorithm="serve_batch", step=step,
                            advance=state.last_advance, ms=ms, n_rows=batch.n_rows,
                            n_solved=state.n_solved, n_unique=state.n_solved_unique,
                            k1_launches=k1, k3_launches=k3))
    carry = [state]

    def one_more():
        carry[0] = serve_batch(g, batch_at(base + (SERVE_ADVANCES + 1) * stride), tger,
                               state=carry[0], access="scan", backend="pallas_tiled")[1]

    prof = profile_query(torch, f"[{name}] serving advance (scan/pallas_tiled, "
                                f"{new_unique} unique new rows)", one_more, warm=False)
    records.append(idle_record(np, name, "serve_batch_profile", prof,
                               [r["ms"] for r in records[1:]]))
    return records


def idle_record(np, name, algorithm, prof, phase_ms, unit="advance"):
    """The profiled ``unit`` (an advance, a query)'s device time against
    the MEDIAN unprofiled one of the same phase (the profiler lengthens
    the call it records, so its own wall clock would overstate the idle
    share), with the phase's spread beside it.  Calls of one phase vary by
    tens of percent, so a profiled call busier than the median one gives a
    negative difference: that is reported as a measurement fault, never
    as a share."""
    lo, med, hi = (float(x) for x in np.percentile(phase_ms, [0, 50, 100]))
    idle = 1 - prof["busy_us"] / (med * 1e3)
    phase = (f"the phase's {len(phase_ms)} unprofiled {unit}s: min {lo:.3f} / "
              f"median {med:.3f} / max {hi:.3f} ms")
    rec = dict(graph=name, algorithm=algorithm, wall_us=prof["wall_us"],
               busy_us=prof["busy_us"], **{f"ms_per_{unit}_median": med,
                                           f"ms_per_{unit}_min": lo,
                                           f"ms_per_{unit}_max": hi})
    if idle < 0:
        log(f"[{name}] {algorithm}: MEASUREMENT FAULT, no idle share: device busy "
            f"{prof['busy_us']:.1f} us exceeds the median {unit}'s {med * 1e3:.1f} us "
            f"({phase})")
        rec["idle_fault"] = idle
        return rec
    log(f"[{name}] {algorithm}: device busy {prof['busy_us']:.1f} us in the median "
        f"unprofiled {unit}'s {med * 1e3:.1f} us: idle share {idle:.3f} ({phase})")
    rec["idle_share"] = idle
    return rec


def ring_stream(torch, np, name, g, tger, fields, access):
    """An index or hybrid ring stream: EA from RING_SOURCES sources over
    SERVE_WINDOWS narrow windows, RING_ADVANCES one-stride advances.  After
    each, the advanced ring equals a cold ring build at its (lo, hi) field
    for field, the rows equal cold sweeps, and the log reads
    ``fused:<access>``."""
    from repro_torch.core.edgemap import hybrid_ring_view, index_ring_view
    from repro_torch.engine import QueryBatch, QuerySpec
    from repro_torch.serve import dispatch_log, serve_batch, sliding_windows, sweep

    sync = torch.cuda.synchronize
    src_np, _, ts_np, te_np = fields
    t_hi = int(te_np.max())
    width = (t_hi - int(ts_np.min())) // 50
    stride = width // 4
    active = np.unique(src_np[ts_np >= t_hi - width])
    srcs = [int(active[len(active) // 3]), int(active[2 * len(active) // 3])]
    build = index_ring_view if access == "index" else hybrid_ring_view

    def batch_at(base):
        return QueryBatch.make([QuerySpec.make("earliest_arrival", tuple(int(x) for x in w),
                                               sources=srcs)
                                for w in sliding_windows(base, width, stride,
                                                         SERVE_WINDOWS)])

    base = t_hi - (RING_ADVANCES + 1) * stride
    _, state = serve_batch(g, batch_at(base), tger, access=access)
    records, fused = [], 0
    for step in range(1, RING_ADVANCES + 1):
        batch = batch_at(base + step * stride)
        lo_prev, budget = state.lo, state.plan.per_vertex_budget
        sync()
        t0 = time.perf_counter()
        with dispatch_log() as tags:
            results, state = serve_batch(g, batch, tger, state=state, access=access)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        scattered = state.lo - lo_prev
        if state.last_advance != "delta" or tags != [f"fused:{access}"]:
            # every advance of the stream must take the ring delta; a cold
            # one names the per-vertex budget its plan held (hybrid's guard)
            raise AssertionError(
                f"[{name}] {access} ring advance {step}: {state.last_advance} {tags}, "
                f"not a ring delta (per-vertex budget {budget} -> "
                f"{state.plan.per_vertex_budget})")
        fused += 1
        cold = build(g, tger, state.lo, state.hi, capacity=state.capacity)
        if not all(torch.equal(a, b) for a, b in zip(state.edges, cold)):
            raise AssertionError(f"[{name}] {access} ring advance {step}: the ring "
                                 f"differs from a cold build")
        wins = np.asarray(sorted({r.window for r in batch.rows()}), np.int32)
        col = {tuple(int(x) for x in w): i for i, w in enumerate(wins)}
        colds = {s: sweep(g, s, wins, tger, plan=state.plan) for s in srcs}
        for qi, r in enumerate(batch.groups()[("earliest_arrival", ())]):
            if not torch.equal(results[0][qi], colds[r.source][col[r.window]]):
                raise AssertionError(f"[{name}] {access} ring advance {step}: row {qi} "
                                     f"differs from the cold sweep")
        log(f"[{name}] {access} ring advance {step}: {state.last_advance} {tags}, "
            f"{scattered} positions scattered into {state.capacity} slots "
            f"(live [{state.lo}, {state.hi})), {ms:.3f} ms, {state.n_solved} rows "
            f"solved; ring equal to a cold build, rows equal to cold sweeps")
        records.append(dict(graph=name, algorithm=f"{access}_ring", step=step,
                            advance=state.last_advance, ms=ms, scattered=scattered,
                            capacity=state.capacity, n_solved=state.n_solved))
    log(f"[{name}] {access} ring: {fused} of {RING_ADVANCES} advances fused")
    carry = [state]

    def one_more():
        carry[0] = serve_batch(g, batch_at(base + (RING_ADVANCES + 1) * stride), tger,
                               state=carry[0], access=access)[1]

    prof = profile_query(torch, f"[{name}] {access} ring advance", one_more, warm=False)
    records.append(idle_record(np, name, f"{access}_ring_profile", prof,
                               [r["ms"] for r in records]))
    records[-1]["fused"] = fused
    return records


# the frontier ladder phase: EA at these caps (0 = dense) in these plan
# cells, the other fixpoints and serving at LADDER_CAP
LADDER_CAPS = (0, 64, 4096)
LADDER_CELLS = (("scan", "pallas_tiled"), ("index", "xla_segment"))
LADDER_CAP = 64
# warm calls per cap, the caps in alternating order (forward, backward, ...):
# the host clock spreads by tens of percent between calls
LADDER_REPS = 7


def alternating(keys, reps):
    """``keys`` forward, then backward, ``reps`` times: each key's calls
    spread evenly over the phase."""
    keys = list(keys)
    for rep in range(reps):
        yield from (keys if rep % 2 == 0 else keys[::-1])


def spread(np, ms) -> dict:
    """Median, min, max and every one of a phase's host-clock times."""
    lo, med, hi = (float(x) for x in np.percentile(ms, [0, 50, 100]))
    return dict(ms=med, ms_min=lo, ms_max=hi, ms_all=list(ms))


@contextlib.contextmanager
def ladder_spy(tem):
    """Record every laddered solve made through the algorithms' public
    entry points: its ``segments`` record and the K1 launches inside it."""
    from unittest import mock

    from repro_torch.core.algorithms import bfs, connectivity, kcore, paths, reachability
    from repro_torch.engine import frontier

    solves = []

    def spy(*args, segments=None, **kw):
        segs = [] if segments is None else segments
        before = tem.segment_min_tiles.launches
        out = frontier.run_laddered(*args, segments=segs, **kw)
        solves.append(dict(segments=segs, k1=tem.segment_min_tiles.launches - before))
        return out

    with contextlib.ExitStack() as stack:
        for mod in (paths, bfs, connectivity, kcore, reachability):
            stack.enter_context(mock.patch.object(mod, "run_laddered", spy))
        yield solves


def segment_summary(segs) -> dict:
    """Counts and rounds of the dense and sparse segments, and the rungs."""
    out = {}
    for kind in ("dense", "sparse"):
        mine = [x for x in segs if x[0] == kind]
        out[f"{kind}_segments"] = len(mine)
        out[f"{kind}_rounds"] = sum(x[3] for x in mine)
    out["rungs"] = [[v, e, n] for kind, v, e, n in segs if kind == "sparse"]
    return out


def ea_trace_oracle(np, src, dst, ts, te, n_v, source, window):
    """The label-correcting EA's per-round occupancy in numpy: vertices
    that receive at least one valid contribution in each round."""
    ta, tb = window
    ok = (ts >= ta) & (te <= tb)
    s, d, s_ts, s_te = src[ok], dst[ok], ts[ok], te[ok]
    arr = np.full(n_v, INF, np.int64)
    arr[source] = ta
    frontier = np.zeros(n_v, bool)
    frontier[source] = True
    trace = []
    while frontier.any():
        e = frontier[s] & (arr[s] <= s_ts)
        touched = np.zeros(n_v, bool)
        touched[d[e]] = True
        trace.append(int(touched.sum()))
        new = arr.copy()
        np.minimum.at(new, d[e], s_te[e])
        frontier = new < arr
        arr = new
    return trace


def ladder_ea(torch, np, name, g, tger, window, sources, solves, tem):
    """EA over the wide window's view from each source, in each LADDER_CELLS
    plan at each LADDER_CAPS cap: arrival and rounds bit-identical across
    the caps and the calls; the first call's ms (it builds the companion),
    then LADDER_REPS warm calls per cap in alternating cap order (median,
    min, max), the segment record and the K1 launches of each query."""
    from repro_torch.core import plan_query
    from repro_torch.core.algorithms import earliest_arrival_over_view
    from repro_torch.core.edgemap import view_for_plan

    sync = torch.cuda.synchronize
    wins = np.asarray([window], np.int32)
    records = []
    for access, backend in LADDER_CELLS:
        plans = {cap: plan_query(g, tger, window, access=access, backend=backend,
                                 ladder=cap) for cap in LADDER_CAPS}
        edges = view_for_plan(g, tger, window, plans[0])   # one view for every cap
        for s in sources:
            def run(plan):
                return earliest_arrival_over_view(edges, wins, plan=plan,
                                                  n_vertices=g.n_vertices,
                                                  sources=[s], with_rounds=True)

            first_ms, ms, k1, segs, ref = {}, {cap: [] for cap in plans}, {}, {}, None
            for cap, plan in plans.items():
                sync()
                t0 = time.perf_counter()
                run(plan)
                sync()
                first_ms[cap] = (time.perf_counter() - t0) * 1e3
            for cap in alternating(plans, LADDER_REPS):
                n_solves, k1_before = len(solves), tem.segment_min_tiles.launches
                sync()
                t0 = time.perf_counter()
                arr, rounds = run(plans[cap])
                sync()
                ms[cap].append((time.perf_counter() - t0) * 1e3)
                k1[cap] = tem.segment_min_tiles.launches - k1_before
                if cap and len(solves) != n_solves + 1:
                    raise AssertionError(f"[{name}] EA ladder {cap}: no laddered solve")
                segs[cap] = solves[-1]["segments"] if cap else []
                if ref is None:
                    ref = (arr, rounds)
                elif not (torch.equal(arr, ref[0]) and rounds == ref[1]):
                    raise AssertionError(f"[{name}] wide src={s} {access}/{backend}: EA "
                                         f"at ladder {cap} differs from the dense solve")
            line = []
            for cap in plans:
                summ, t = segment_summary(segs[cap]), spread(np, ms[cap])
                records.append(dict(graph=name, algorithm="ea_ladder", window="wide",
                                    source=s, cell=f"{access}/{backend}", ladder=cap,
                                    first_ms=first_ms[cap], rounds=ref[1],
                                    k1_launches=k1[cap],
                                    segments=[list(x) for x in segs[cap]], **t, **summ))
                line.append(f"L{cap} median {t['ms']:.3f} ms (min {t['ms_min']:.3f}, max "
                            f"{t['ms_max']:.3f}, first {first_ms[cap]:.3f}), K1 {k1[cap]}"
                            + (f", dense {summ['dense_segments']} seg / "
                               f"{summ['dense_rounds']} rounds, sparse "
                               f"{summ['sparse_segments']} seg / {summ['sparse_rounds']} "
                               f"rounds, rungs (v, e, rounds) {summ['rungs']}" if cap else ""))
            log(f"[{name}] ladder EA wide {window} src={s} {access}/{backend}: "
                f"{ref[1]} rounds, {int((ref[0] < INF).sum())} reached, bit-identical "
                f"across caps and calls; {LADDER_REPS} warm calls per cap in turns; "
                + "; ".join(line))
    return records


def ladder_fixpoints(torch, np, name, g, tger, window, sources, solves, tem):
    """BFS, CC, k-core, overlaps reachability and betweenness over the
    narrow window's scan view on pallas_tiled, laddered (LADDER_CAP)
    against dense: integer outputs bit-identical; betweenness's float
    dependencies (the Brandes passes sum with float atomics on the card,
    in no fixed order) within 1e-5 of the largest, its bit-identity
    reported."""
    from repro_torch.core import plan_query
    from repro_torch.core.algorithms import (
        overlaps_reachability_over_view,
        temporal_betweenness_over_view,
        temporal_bfs_over_view,
        temporal_cc_over_view,
        temporal_kcore_over_view,
    )
    from repro_torch.core.edgemap import view_for_plan

    sync = torch.cuda.synchronize
    plans = {cap: plan_query(g, tger, window, access="scan", backend="pallas_tiled",
                             ladder=cap) for cap in (0, LADDER_CAP)}
    edges = view_for_plan(g, tger, window, plans[0])
    V = g.n_vertices
    srcs = sources[:2]
    bc = sources[:BETWEENNESS_SOURCES]
    one = np.asarray([window], np.int32)

    def rows(k):
        return np.repeat(one, k, axis=0)

    runs = {
        "bfs": lambda p: temporal_bfs_over_view(edges, rows(len(srcs)), plan=p,
                                                n_vertices=V, sources=srcs),
        "cc": lambda p: temporal_cc_over_view(edges, one, plan=p, n_vertices=V),
        "kcore": lambda p: temporal_kcore_over_view(edges, one, plan=p, n_vertices=V,
                                                    k=KCORE_K),
        "reachability": lambda p: overlaps_reachability_over_view(
            edges, rows(len(srcs)), plan=p, n_vertices=V, sources=srcs),
        "betweenness": lambda p: temporal_betweenness_over_view(
            edges, rows(len(bc)), plan=p, n_vertices=V, sources=bc),
    }
    records = []
    for alg, run in runs.items():
        out, ms, k1, segs = {}, {cap: [] for cap in plans}, {}, []
        for plan in plans.values():
            run(plan)    # warm-up: companions
        for cap in alternating(plans, LADDER_REPS):
            n_solves, k1_before = len(solves), tem.segment_min_tiles.launches
            sync()
            t0 = time.perf_counter()
            res = run(plans[cap])
            sync()
            ms[cap].append((time.perf_counter() - t0) * 1e3)
            k1[cap] = tem.segment_min_tiles.launches - k1_before
            out[cap] = res if isinstance(res, tuple) else (res,)
            if cap:
                if len(solves) != n_solves + 1:
                    raise AssertionError(f"[{name}] {alg} ladder: no laddered solve")
                segs = solves[-1]["segments"]
        same = all(torch.equal(a, b) for a, b in zip(out[0], out[LADDER_CAP]))
        if alg == "betweenness":
            a, b = out[0][0].double(), out[LADDER_CAP][0].double()
            scale = max(float(a.abs().max()), 1.0)
            diff = float((a - b).abs().max())
            if not (bool(torch.isfinite(b).all()) and diff <= 1e-5 * scale):
                raise AssertionError(f"[{name}] betweenness laddered off dense: {diff}")
            note = ("bit-identical" if same else
                    f"within 1e-5 of max (max |diff| {diff:.3g}; not bit-identical)")
        elif not same:
            raise AssertionError(f"[{name}] {alg} laddered differs from dense")
        else:
            note = "bit-identical"
        summ = segment_summary(segs)
        t = {cap: spread(np, v) for cap, v in ms.items()}
        log(f"[{name}] ladder {alg} narrow {window} scan/pallas_tiled, median (min-max) "
            f"of {LADDER_REPS} warm calls each, in turns: dense {t[0]['ms']:.3f} "
            f"({t[0]['ms_min']:.3f}-{t[0]['ms_max']:.3f}) ms (K1 {k1[0]}), L{LADDER_CAP} "
            f"{t[LADDER_CAP]['ms']:.3f} ({t[LADDER_CAP]['ms_min']:.3f}-"
            f"{t[LADDER_CAP]['ms_max']:.3f}) ms (K1 {k1[LADDER_CAP]}; {summ}); {note}")
        records.append(dict(graph=name, algorithm=f"{alg}_ladder", window="narrow",
                            ms={str(c): v for c, v in t.items()},
                            k1_launches={str(c): n for c, n in k1.items()},
                            bit_identical=same, **summ))
    return records


def ladder_serving(torch, np, name, g, tger, fields, solves, failures):
    """The ``serving_stream`` batch served twice side by side, dense and
    with ``ladder=LADDER_CAP``: a cold start (its fixpoint groups laddered)
    and SERVE_ADVANCES advances (dense: no laddered solve); every integer
    row equal to the dense chain's, PageRank rows (K3 sums with atomics in
    no fixed order) within the PageRank phase's tolerance, the dispatch
    tags equal."""
    from repro_torch.device import to_numpy
    from repro_torch.serve import dispatch_log, serve_batch

    sync = torch.cuda.synchronize
    batch_at, base, stride = serving_stream(np, fields)
    st = {0: None, LADDER_CAP: None}
    records = []
    for step in range(SERVE_ADVANCES + 1):
        batch = batch_at(base + step * stride)
        res, tags, ms, laddered = {}, {}, {}, {}
        for cap in st:
            n_solves = len(solves)
            sync()
            t0 = time.perf_counter()
            with dispatch_log() as tags[cap]:
                res[cap], st[cap] = serve_batch(g, batch, tger, state=st[cap],
                                                access="scan", backend="pallas_tiled",
                                                ladder=cap)
            sync()
            ms[cap] = (time.perf_counter() - t0) * 1e3
            laddered[cap] = solves[n_solves:]
        if tags[0] != tags[LADDER_CAP]:
            raise AssertionError(f"[{name}] ladder serving {step}: tags {tags[LADDER_CAP]} "
                                 f"!= dense {tags[0]}")
        n_lad = len(laddered[LADDER_CAP])
        # the cold start ladders its EA, BFS and CC groups; advances none
        if laddered[0] or n_lad != (3 if step == 0 else 0):
            raise AssertionError(f"[{name}] ladder serving {step}: {n_lad} laddered solves")
        for gi, ((alg, _), _) in enumerate(batch.groups().items()):
            a, b = res[0][gi], res[LADDER_CAP][gi]
            if alg == "pagerank":
                for qi in range(a.shape[0]):
                    check_pagerank(np, f"[{name}] ladder serving {step} pagerank row {qi}",
                                   to_numpy(b[qi]), to_numpy(a[qi]).astype(np.float64),
                                   failures)
            elif not _bit_equal(torch, a, b):
                raise AssertionError(f"[{name}] ladder serving {step}: {alg} rows differ")
        k1 = sum(x["k1"] for x in laddered[LADDER_CAP])
        summ = [segment_summary(x["segments"]) for x in laddered[LADDER_CAP]]
        log(f"[{name}] ladder serving {st[LADDER_CAP].last_advance} {step}: dense "
            f"{ms[0]:.3f} ms, L{LADDER_CAP} {ms[LADDER_CAP]:.3f} ms; tags {tags[0]}; "
            f"{n_lad} laddered solves (K1 {k1} inside; {summ}); rows equal")
        records.append(dict(graph=name, algorithm="serve_batch_ladder", step=step,
                            advance=st[LADDER_CAP].last_advance,
                            ms={str(c): t for c, t in ms.items()}, laddered_solves=n_lad,
                            laddered_k1=k1, segments=summ))
    return records


def _bit_equal(torch, a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def ladder_primitives(torch, np, name, g, tger, fields, window, source, tem):
    """An EA loop written with the TemporalEdgeMap primitives alone
    (temporal_edge_map, vertex_map, frontier_nonempty) on scan/pallas_tiled:
    equal to ``earliest_arrival`` bit for bit, one K1 launch per round; and
    ``frontier_trace`` of the same query equal to the numpy oracle's."""
    from repro_torch.core import plan_query, temporal_edge_map, vertex_map
    from repro_torch.core.algorithms import earliest_arrival
    from repro_torch.core.edgemap import frontier_from_sources, frontier_nonempty
    from repro_torch.core.predicates import OrderingPredicateType, edge_follows

    sync = torch.cuda.synchronize
    plan = plan_query(g, tger, window, access="scan", backend="pallas_tiled")
    V = g.n_vertices

    def relax(edges, arr_src):
        return edges.t_end, edge_follows(OrderingPredicateType.SUCCEEDS, arr_src,
                                         edges.t_start, edges.t_end)

    k1_before = tem.segment_min_tiles.launches
    sync()
    t0 = time.perf_counter()
    arrival = torch.full((V,), INF, dtype=torch.int32, device=g.device)
    arrival[source] = window[0]
    frontier = frontier_from_sources(V, [source], device=g.device)
    rounds = 0
    while bool(frontier_nonempty(frontier)):
        cand, _ = temporal_edge_map(g, window, frontier, arrival, relax, "min",
                                    tger=tger, plan=plan, compute_touched=False)
        new = torch.minimum(arrival, cand)
        frontier = vertex_map(new < arrival, lambda v: v < V)
        arrival = new
        rounds += 1
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    k1 = tem.segment_min_tiles.launches - k1_before
    want, metrics = earliest_arrival(g, source, window, tger, plan=plan, with_metrics=True,
                                     frontier_trace=True)
    if not torch.equal(arrival, want) or rounds != metrics.rounds or k1 != rounds:
        raise AssertionError(f"[{name}] primitives EA: rounds {rounds} / "
                             f"{metrics.rounds}, K1 {k1}, equal {torch.equal(arrival, want)}")
    trace = metrics.frontier_trace.numpy()
    oracle = ea_trace_oracle(np, *(f.astype(np.int64) for f in fields), V, source, window)
    if not ((trace[:len(oracle)] == np.asarray(oracle)).all() and len(oracle) == rounds
            and (trace[len(oracle):] == -1).all()):
        raise AssertionError(f"[{name}] frontier_trace differs from the numpy oracle")
    log(f"[{name}] primitives EA loop wide {window} src={source} scan/pallas_tiled: "
        f"{ms:.3f} ms, {rounds} rounds, K1 {k1} launches; equal to earliest_arrival. "
        f"frontier_trace equal to the numpy oracle: peak {max(oracle)} vertices, last "
        f"rounds {oracle[-5:]}")
    return [dict(graph=name, algorithm="primitives_ea", window="wide", source=source,
                 ms=ms, rounds=rounds, k1_launches=k1, frontier_trace_peak=max(oracle),
                 frontier_trace=oracle)]


def ladder_path(torch, np, graphs, contexts, failures, tem):
    """The frontier ladder at wiki-talk size: EA on both wide windows, the
    other fixpoints on the narrow one, serving, the primitives loop and
    frontier_trace, and profiles of one laddered and one dense EA query on
    transit wide.  Returns (records, K1 launches inside laddered solves)."""
    from repro_torch.core import plan_query
    from repro_torch.core.algorithms import earliest_arrival_over_view
    from repro_torch.core.edgemap import view_for_plan

    records = []
    with ladder_spy(tem) as solves:
        for name in ("transit", "power_law"):
            g = graphs[name]
            tger, fields, windows, sources = contexts[name]
            records += ladder_ea(torch, np, name, g, tger, windows["wide"], sources[:2],
                                 solves, tem)
            records += ladder_fixpoints(torch, np, name, g, tger, windows["narrow"],
                                        sources, solves, tem)
        g = graphs["transit"]
        tger, fields, windows, sources = contexts["transit"]
        records += ladder_primitives(torch, np, "transit", g, tger, fields,
                                     windows["wide"], sources[0], tem)
        records += ladder_serving(torch, np, "power_law", graphs["power_law"],
                                  contexts["power_law"][0], contexts["power_law"][1],
                                  solves, failures)
        laddered_k1 = sum(x["k1"] for x in solves)
        wins = np.asarray([windows["wide"]], np.int32)
        for cap in (LADDER_CAP, 0):
            plan = plan_query(g, tger, windows["wide"], access="scan",
                              backend="pallas_tiled", ladder=cap)
            edges = view_for_plan(g, tger, windows["wide"], plan)
            prof = profile_query(
                torch, f"[transit] EA wide src={sources[0]} scan/pallas_tiled ladder {cap}",
                lambda: earliest_arrival_over_view(edges, wins, plan=plan,
                                                   n_vertices=g.n_vertices,
                                                   sources=[sources[0]]))
            unprofiled = next(r["ms_all"] for r in records
                              if r["algorithm"] == "ea_ladder" and r["graph"] == "transit"
                              and r["source"] == sources[0] and r["ladder"] == cap
                              and r["cell"] == "scan/pallas_tiled")
            rec = idle_record(np, "transit", f"EA wide ladder {cap} profile", prof,
                              unprofiled, unit="query")
            records.append(dict(rec, algorithm="ea_ladder_profile", ladder=cap))
    if laddered_k1 <= 0:
        raise AssertionError("K1 was never launched inside a laddered solve")
    log(f"ladder phase: {len(solves)} laddered solves, K1 {laddered_k1} launches inside them")
    return records, laddered_k1


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


def decode_phases(torch, np, cfg, gen, k4, parent=None):
    """K4 at the LM's decode shape (LM_SLOTS rows, LM_MAX_SEQ positions),
    inputs drawn from ``gen`` on its device, each against its plain version
    on float32 copies (K4_TOL), timed beside scaled_dot_product_attention
    (boolean length mask, GQA; K and V in its [B, KH, S, Dh] layout, made
    outside the timing) and the bytes bound, and with ``parent`` beside the
    kernel before its redesign, in turns:
    - bfloat16 (the serving type) and float32 at ragged lengths in
      [1, LM_MAX_SEQ], on one set of caches (warm: their valid part fits
      the 50 MB L2), as timed since the kernel's first version;
    - bfloat16 cold, rotating through K4_SETS sets of caches, at the same
      lengths and at serving lengths (K4_SERVING_LENGTHS), as a decode step
      meets every layer's cache."""
    import torch.nn.functional as F

    dev = gen.device
    B, S, KH, Dh = LM_SLOTS, LM_MAX_SEQ, cfg.n_kv_heads, cfg.head_dim
    H = cfg.n_heads

    def draw(dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, H, Dh), (B, S, KH, Dh), (B, S, KH, Dh)))

    def length_mask(lens):
        return (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]

    def sdpa(q, ks, vs, mask):
        return F.scaled_dot_product_attention(q[:, :, None, :], ks, vs, attn_mask=mask,
                                              enable_gqa=True)

    def bound(lens, esize):
        # K and V up to each row's length, q and o once, the lengths
        n_valid = int(lens.sum())
        return bound_ms(2 * n_valid * KH * Dh * esize + 2 * B * H * Dh * esize + 4 * B,
                        4 * n_valid * H * Dh)

    def checked(q, k, v, lens, name):
        want = k4.decode_attention_plain(q.float(), k.float(), v.float(), lens).to(q.dtype)
        err = close_err(torch, k4.decode_attention(q, k, v, lens), want, **K4_TOL[name])
        if parent:
            close_err(torch, parent_k4(torch, parent, q, k, v, lens), want, **K4_TOL[name])
        return err, want

    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    mask = length_mask(lens)
    recs = {}
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        q, k, v = draw(dtype)
        err, want = checked(q, k, v, lens, name)
        got = k4.decode_attention(q, k, v, lens)
        typed = k4.decode_attention_plain(q, k, v, lens)
        ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_err = close_err(torch, sdpa(q, ks, vs, mask)[:, :, 0], want, **LIBRARY_TOL[name])
        old = (lambda: parent_k4(torch, parent, q, k, v, lens)) if parent else None
        ms, parent_ms, turns = timed_pair(torch, lambda: k4.decode_attention(q, k, v, lens),
                                          old)
        rec = dict(
            max_abs_err=err, plain_typed_max_abs_err=float((got.double() - typed.double())
                                                           .abs().max()),
            library_max_abs_err=lib_err, ms=ms,
            host_paced_ms=cuda_ms(torch, lambda: k4.decode_attention(q, k, v, lens),
                                  prefill=False),
            plain_ms=cuda_ms(torch, lambda: k4.decode_attention_plain(q, k, v, lens)),
            library_ms=cuda_ms(torch, lambda: sdpa(q, ks, vs, mask)),
        )
        if parent:
            rec.update(parent_ms=parent_ms, ab_turns_ms=turns)
        rec["bound_ms"], rec["bound_by"] = bound(lens, q.element_size())
        log(f"K4 decode_attention [B={B}, S={S}, KH={KH}, G={H // KH}, Dh={Dh}, {name}, "
            f"{int(lens.sum())} valid positions, warm]: within rtol "
            f"{K4_TOL[name]['rtol']:.3g} / atol {K4_TOL[name]['atol']:.3g} of the plain "
            f"version on float32 copies; {rec}")
        recs[name] = rec
        del q, k, v, ks, vs

    # bfloat16, cold: K4_SETS sets of caches, used in turn
    sets = []
    for _ in range(K4_SETS):
        q, k, v = draw(torch.bfloat16)
        sets.append((q, k, v, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()))
    serve = torch.randint(K4_SERVING_LENGTHS[0], K4_SERVING_LENGTHS[1] + 1, (B,),
                          generator=gen, device=dev, dtype=torch.int32)
    for label, ls in (("cold", lens), ("serving_cold", serve)):
        m = length_mask(ls)
        err, _ = checked(*sets[0][:3], ls, "bfloat16")
        old = (rotating(lambda q, k, v, ks, vs: parent_k4(torch, parent, q, k, v, ls), sets)
               if parent else None)
        ms, parent_ms, turns = timed_pair(
            torch, rotating(lambda q, k, v, ks, vs: k4.decode_attention(q, k, v, ls), sets),
            old)
        rec = dict(max_abs_err=err, ms=ms, valid_positions=int(ls.sum()),
                   library_ms=cuda_ms(torch, rotating(
                       lambda q, k, v, ks, vs: sdpa(q, ks, vs, m), sets)))
        if parent:
            rec.update(parent_ms=parent_ms, ab_turns_ms=turns)
        rec["bound_ms"], rec["bound_by"] = bound(ls, 2)
        log(f"K4 decode_attention [bfloat16, {label}: {K4_SETS} sets of caches in turn, "
            f"lengths {ls.tolist()}]: within rtol 2**-7 / atol 2**-12 of the plain version "
            f"on float32 copies; {rec}")
        recs["bfloat16"][label] = rec
    del sets
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:82",
                shape=dict(B=B, S=S, KH=KH, G=H // KH, Dh=Dh,
                           valid_positions=int(lens.sum())),
                **recs["bfloat16"], float32=recs["float32"],
                library_note="scaled_dot_product_attention, boolean length mask, "
                             "enable_gqa")


def _padded(np, seq, q_chunk):
    """Token ids [1, S'] for ``forward``: S' is S, or the next multiple of
    q_chunk when S is longer (the chunking needs it; causal attention keeps
    the padding out of the first S positions)."""
    s_len = len(seq)
    if s_len > q_chunk:
        s_len = -(-s_len // q_chunk) * q_chunk
    toks = np.zeros((1, s_len), np.int32)
    toks[0, :len(seq)] = seq
    return toks


def _rel(a, b):
    """Relative L2 error of ``a`` against ``b``."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def _rel_rows(a, b):
    """Relative L2 error of each row (first axis) of ``a`` against ``b``."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return (a - b).norm(dim=1) / b.norm(dim=1)


def layer_errors(torch, np, model, seq, p):
    """Teacher-forced per layer at position ``p`` of ``seq``: the decode
    block fed forward's input to that block and a cache of forward's K/V
    before p, against forward's block output and K/V at p, once with K4
    (on the card) and once with K4's plain version in its place.  Returns
    the relative L2 errors [(h, k, v, h_plain)] per layer."""
    from unittest import mock

    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.models import transformer as tf

    cfg, dev = model.cfg, model.device
    toks = torch.as_tensor(_padded(np, seq, cfg.q_chunk), device=dev)
    S = toks.shape[1]
    h = model.embed[toks].to(cfg.dtype)
    rot = tf.rope_tables(torch.arange(S, device=dev)[None], cfg.head_dim, cfg.rope_theta)
    at = torch.tensor([p], device=dev)
    rot_p = tf.rope_tables(at[:, None], cfg.head_dim, cfg.rope_theta)
    slot = (torch.arange(1, device=dev), at, (at + 1).to(torch.int32))
    kc = torch.zeros((1, S, cfg.n_kv_heads, cfg.head_dim), dtype=cfg.dtype, device=dev)
    vc = torch.zeros_like(kc)

    out = []
    for blk in model.layers:
        h_in = h[:, p]
        h, k, v = tf.layer_forward(cfg, blk, h, rot)
        kc[0, :p], vc[0, :p] = k[0, :p], v[0, :p]
        with mock.patch.object(tf, "decode_attention", decode_attention_plain):
            h_plain = tf.layer_decode(cfg, blk, h_in, kc, vc, slot, rot_p)
        h_dec = tf.layer_decode(cfg, blk, h_in, kc, vc, slot, rot_p)
        out.append((_rel(h_dec, h[:, p]), _rel(kc[0, p], k[0, p]), _rel(vc[0, p], v[0, p]),
                    _rel(h_plain, h[:, p])))
    return out


def check_engine_state(torch, np, model, reqs, h0_rows, kv0):
    """The engine's own decode state at layer 0, read during the served run
    (``lm_path``): ``h0_rows[rid]`` holds (position, layer-0 output row) of
    each decode step of request ``rid`` and ``kv0[rid]`` its slot's layer-0
    K/V rows after its last step.  Against forward's layer 0 over the
    request's prompt and generated prefix: the K/V rows (LM_KV_TOL), and
    the outputs against layer 0's decode block fed forward's K/V at each
    decoded position (median within LM_KV_TOL, each within
    LM_STATE_H_MAX), so that what is compared is the engine's state and not
    the two attention routes' rounding; forward's own outputs are
    reported.  The decoded positions must be exactly those after the
    prompt.  Raises on a miss, returns the figures."""
    from repro_torch.models.transformer import layer_decode, layer_forward, rope_tables

    cfg, dev = model.cfg, model.device
    blk = model.layers[0]
    kv_err, h_err, fwd_err = [], [], []
    for r in reqs:
        if len(r.generated) < 2:
            if r.rid in h0_rows:
                raise AssertionError(f"[lm] request {r.rid} decoded with a budget of "
                                     f"{r.max_new_tokens}")
            continue
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1], np.int32)])
        positions = [p for p, _ in h0_rows[r.rid]]
        if positions != list(range(len(r.prompt), len(seq))):
            raise AssertionError(f"[lm] request {r.rid} decoded positions {positions[:3]}.."
                                 f"{positions[-3:]}, expected {len(r.prompt)}..{len(seq) - 1}")
        toks = torch.as_tensor(_padded(np, seq, cfg.q_chunk), device=dev)
        S = toks.shape[1]
        rot = rope_tables(torch.arange(S, device=dev)[None], cfg.head_dim, cfg.rope_theta)
        h, k, v = layer_forward(cfg, blk, model.embed[toks].to(cfg.dtype), rot)
        kc, vc = kv0[r.rid]
        kv_err.append(torch.maximum(_rel_rows(kc, k[0, :len(seq)]),
                                    _rel_rows(vc, v[0, :len(seq)])).max().item())
        # every decoded position at once, one row each over forward's K/V
        at = torch.tensor(positions, device=dev)
        n = len(positions)
        slot = (torch.arange(n, device=dev), at, (at + 1).to(torch.int32))
        ref = layer_decode(cfg, blk, model.embed[toks[0, at]].to(cfg.dtype),
                           k.expand(n, -1, -1, -1).contiguous(),
                           v.expand(n, -1, -1, -1).contiguous(), slot,
                           rope_tables(at[:, None], cfg.head_dim, cfg.rope_theta))
        rows = torch.stack([row for _, row in h0_rows[r.rid]])
        h_err += _rel_rows(rows, ref).tolist()
        fwd_err += _rel_rows(rows, h[0, at]).tolist()
    kv_max, h_med, h_max = max(kv_err), float(np.median(h_err)), max(h_err)
    log(f"[lm] engine state at layer 0, {len(kv_err)} requests: K/V rows of each slot, "
        f"largest relative error {kv_max:.3g} (tol {LM_KV_TOL:.3g}); the output at "
        f"{len(h_err)} decoded positions against the decode block on forward's K/V: median "
        f"{h_med:.3g} (tol {LM_KV_TOL:.3g}), max {h_max:.3g} (tol {LM_STATE_H_MAX}); "
        f"against forward's output (reported): median {np.median(fwd_err):.3g}, max "
        f"{max(fwd_err):.3g}")
    if kv_max > LM_KV_TOL or h_med > LM_KV_TOL or h_max > LM_STATE_H_MAX:
        raise AssertionError(f"[lm] engine state off forward's at layer 0: K/V {kv_max:.3g}, "
                             f"output median {h_med:.3g}, max {h_max:.3g}")
    return dict(state_kv_max_rel_err=kv_max, state_h0_median_rel_err=h_med,
                state_h0_max_rel_err=h_max, state_h0_forward_median_rel_err=float(
                    np.median(fwd_err)), state_decoded_positions=len(h_err))


def check_served_tokens(torch, np, model, reqs):
    """The checks of the served tokens described at LM_LOGIT_TOL; raises on
    a miss, returns the figures."""
    import dataclasses

    from repro_torch.models.transformer import LM, forward

    cfg, dev = model.cfg, model.device
    t0 = time.perf_counter()
    served = [r for r in reqs if r.generated]
    # 1. the first token, from prefill, against forward over the prompt
    first_gap, exact = 0.0, 0
    for r in served:
        row = forward(model, torch.as_tensor(r.prompt, device=dev)[None])[0, -1]
        first_gap = max(first_gap, float(row.max() - row[r.generated[0]]))
        exact += int(int(row.argmax()) == r.generated[0])
    first_share = exact / len(served)
    log(f"[lm] first tokens (prefill) against forward over the prompt: argmax agrees "
        f"on {exact} of {len(served)}; largest gap to the row's max {first_gap:.4f} "
        f"(tol {LM_LOGIT_TOL})")
    if first_share < LM_ARGMAX_MIN or first_gap > LM_LOGIT_TOL:
        raise AssertionError(f"[lm] first tokens off forward: argmax share {first_share:.4f} "
                             f"(min {LM_ARGMAX_MIN}), largest gap {first_gap:.4f}")

    # 2. every layer of a decode step, teacher-forced, bfloat16 and float32
    decoded = [r for r in served if len(r.generated) >= 2]
    wide_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    wide = LM(wide_cfg, {n: p.float() for n, p in model.named_parameters(recurse=False)},
              [{n: p.float() for n, p in blk.named_parameters()} for blk in model.layers])
    figures = {}
    for name, m, rs in (("bfloat16", model, decoded),
                        ("float32", wide, decoded[:LM_F32_REQUESTS])):
        errs = []
        for r in rs:
            seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1], np.int32)])
            errs += layer_errors(torch, np, m, seq, len(seq) - 1)
        errs = np.asarray(errs)  # [requests x layers, (h, k, v, h_plain)]
        kv_max, plain_max = float(errs[:, 1:3].max()), float(errs[:, 3].max())
        h_med, h_max = float(np.median(errs[:, 0])), float(errs[:, 0].max())
        figures[name] = dict(h_med=h_med, h_max=h_max, kv_max=kv_max, plain_max=plain_max)
        log(f"[lm] decode blocks teacher-forced, {name}: {len(rs)} requests x "
            f"{cfg.n_layers} layers; relative error of the block output with K4: median "
            f"{h_med:.3g}, max {h_max:.3g}; with K4's plain version: median "
            f"{np.median(errs[:, 3]):.3g}, max {plain_max:.3g}; of the written K/V: max "
            f"{kv_max:.3g} (tol {LM_LAYER_TOL[name]:.3g})")
        worst = float(errs.max()) if name == "float32" else max(kv_max, h_med, plain_max)
        if worst > LM_LAYER_TOL[name]:
            raise AssertionError(f"[lm] decode blocks off forward's in {name}: "
                                 f"{worst:.3g} > {LM_LAYER_TOL[name]:.3g}")
    del wide

    # 3. end to end, reported: each token against forward over prompt + prefix
    gaps, exact = [], 0
    for r in served:
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1], np.int32)])
        rows = forward(model, torch.as_tensor(_padded(np, seq, cfg.q_chunk), device=dev))[
            0, len(r.prompt) - 1: len(seq)]
        tok = torch.as_tensor(r.generated, device=dev)
        gaps += (rows.max(dim=-1).values - rows.gather(1, tok[:, None])[:, 0]).tolist()
        exact += int((rows.argmax(dim=-1) == tok).sum())
    gaps = np.asarray(gaps)
    log(f"[lm] end to end (reported, not required): {exact} of {len(gaps)} served tokens "
        f"are forward's argmax over prompt + prefix ({exact / len(gaps):.4f}); gap to the "
        f"row's max: median {np.median(gaps):.4f}, max {gaps.max():.4f}; checks took "
        f"{time.perf_counter() - t0:.2f} s")
    return dict(first_token_argmax_share=first_share, first_token_max_gap=first_gap,
                layer_max_rel_err_bf16=figures["bfloat16"]["h_max"],
                layer_median_rel_err_bf16=figures["bfloat16"]["h_med"],
                layer_plain_max_rel_err_bf16=figures["bfloat16"]["plain_max"],
                layer_kv_max_rel_err_bf16=figures["bfloat16"]["kv_max"],
                layer_max_rel_err_f32=figures["float32"]["h_max"],
                end_to_end_argmax_share=exact / len(gaps),
                end_to_end_median_gap=float(np.median(gaps)))


def lm_path(torch, np, model, seed):
    """LM continuous batching: a ServeEngine of LM_SLOTS slots and
    LM_MAX_SEQ positions serving LM_REQUESTS prompts from ``seed`` with
    mixed budgets (one of 1, one of 0) on ``model``.  Launch counts are
    reset just before the served run and read just after; layer 0 of every
    decode step is read during it for ``check_engine_state``; then every
    generated token is checked teacher-forced against ``forward``."""
    from unittest import mock

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, dev = model.cfg, model.device
    sync = torch.cuda.synchronize
    rng = np.random.default_rng(seed)
    plens = rng.integers(LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + 1, LM_REQUESTS)
    budgets = rng.integers(2, LM_MAX_NEW + 1, LM_REQUESTS)
    budgets[3], budgets[7], budgets[11] = 1, 0, LM_MAX_NEW
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=int(b)) for i, (n, b) in enumerate(zip(plens, budgets))]

    # warm-up outside the counted run: one prefill and one decode step
    warm = torch.as_tensor(reqs[0].prompt[:64], device=dev)[None]
    _, cache = tf.prefill(model, warm, max_seq=128)
    tf.decode_step(model, cache, warm[:, -1], torch.tensor([warm.shape[1]], device=dev))
    sync()
    del cache

    engine = ServeEngine(model, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    prefill_ms, decode_ms = [], []
    # layer 0 of each decode step: its output rows, and which request each
    # slot holds at which position
    h0_rows, kv0, layer0, live = {}, {}, [], []
    layer_decode = tf.layer_decode

    def record_layer0(cfg_, blk, *args):
        out = layer_decode(cfg_, blk, *args)
        if blk is model.layers[0]:
            layer0.append(out)
        return out

    def timed(fn, out):
        # each engine phase ends in a host read of its argmax, a device sync
        def run(*args):
            t = time.perf_counter()
            r = fn(*args)
            out.append((time.perf_counter() - t) * 1e3)
            return r
        return run

    def decode():
        live[:] = [(s, r, int(engine.lengths[s])) for s, r in enumerate(engine.active)
                   if r is not None]
        next_tokens = timed_decode()
        h0 = layer0.pop()
        for s, r, p in live:
            h0_rows.setdefault(r.rid, []).append((p, h0[s]))
        return next_tokens

    engine._prefill = timed(engine._prefill, prefill_ms)
    timed_decode = timed(engine._decode, decode_ms)
    engine._decode = decode
    for r in reqs:
        engine.submit(r)
    profile, profiled, kv_positions = None, None, 0
    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(tf, "layer_decode", record_layer0):
        while True:
            refill = engine.queue and any(r is None for r in engine.active)
            if profile is None and not refill and engine.stats.steps >= 10:
                profiled = len(decode_ms)
                kv_positions = int(engine.lengths.sum()) + LM_SLOTS  # each attends len + 1
                box = []
                profile = profile_query(torch, f"[lm] one decode step ({LM_SLOTS} slots)",
                                        lambda: box.append(engine.step()), top=10, warm=False)
                n = box[0]
            else:
                n = engine.step()
            # a request finished in this step: its slot's layer-0 rows, before
            # the next step's refill reuses the slot
            for s, r, p in live:
                if engine.active[s] is not r:
                    kv0[r.rid] = (engine.cache["k"][0, s, :p + 1].clone(),
                                  engine.cache["v"][0, s, :p + 1].clone())
            live.clear()
            if n == 0 and not engine.queue:
                break
    serve_s = time.perf_counter() - t0
    counts = launch_counts()
    stats = engine.stats
    log(f"[lm] served {stats.requests_completed}/{LM_REQUESTS} requests, "
        f"{stats.tokens_generated} tokens in {stats.steps} decode steps, {serve_s:.3f} s; "
        f"launches {counts}")

    served = [int(b) for b in budgets]
    if stats.requests_completed != LM_REQUESTS:
        raise AssertionError(f"[lm] {stats.requests_completed} of {LM_REQUESTS} completed")
    if stats.tokens_generated != sum(served):
        raise AssertionError(f"[lm] {stats.tokens_generated} tokens for budgets summing "
                             f"to {sum(served)}")
    for r in reqs:
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"[lm] request {r.rid}: {len(r.generated)} tokens for a "
                                 f"budget of {r.max_new_tokens}")
    if counts["decode_attention"] != cfg.n_layers * stats.steps:
        raise AssertionError(f"[lm] K4 launched {counts['decode_attention']} times for "
                             f"{cfg.n_layers} layers x {stats.steps} steps")

    checks = check_engine_state(torch, np, model, reqs, h0_rows, kv0)
    del h0_rows, kv0
    checks.update(check_served_tokens(torch, np, model, reqs))

    steady = [t for i, t in enumerate(decode_ms) if i != profiled]
    step_us = float(np.mean(steady)) * 1e3
    decode_tokens = stats.tokens_generated - len(prefill_ms)
    k4_keys = [key for key in profile["by_kernel"] if "decode_" in key and "kernel" in key]
    k4_us = sum(profile["by_kernel"][key] for key in k4_keys)
    k4_profile_launches = sum(profile["count_by_kernel"][key] for key in k4_keys)
    # least bytes of the profiled step: every weight but the embedding table
    # (of which LM_SLOTS rows), and K and V of the positions each slot attends
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    esize = model.embed.element_size()
    step_bytes = (weight_bytes - model.embed.numel() * esize + LM_SLOTS * cfg.d_model * esize
                  + 2 * cfg.n_layers * kv_positions * cfg.n_kv_heads * cfg.head_dim * esize)
    bound = step_bytes / PEAK_BYTES_PER_S * 1e3
    rec = dict(
        graph="lm", algorithm="serve", arch=cfg.name, slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
        requests=LM_REQUESTS, steps=stats.steps, tokens=stats.tokens_generated,
        decode_tokens=decode_tokens, serve_s=serve_s,
        prefill_ms_per_request=float(np.mean(prefill_ms)),
        prefill_ms=[round(t, 3) for t in prefill_ms],
        prompt_lens=[int(n) for n in plens],
        decode_ms_per_step=step_us / 1e3,
        decode_ms_median=float(np.median(steady)),
        decode_tokens_per_s=decode_tokens / (sum(decode_ms) / 1e3),
        weight_bytes=weight_bytes, profiled_step_bytes=step_bytes,
        profiled_step_bound_ms=bound,
        profile_wall_us=profile["wall_us"], profile_busy_us=profile["busy_us"],
        # against an unprofiled step: the profiler lengthens the step it records
        decode_idle_share=1 - profile["busy_us"] / step_us,
        profile_k4_us=k4_us, profile_k4_share=k4_us / profile["busy_us"],
        profile_k4_launches=k4_profile_launches,
        k4_launches=counts["decode_attention"], **checks)
    log(f"[lm] prefill {rec['prefill_ms_per_request']:.3f} ms per request (mean of "
        f"{len(prefill_ms)}, prompts {LM_PROMPT_LEN[0]}-{LM_PROMPT_LEN[1]} tokens); decode "
        f"{rec['decode_ms_per_step']:.3f} ms per step (median {rec['decode_ms_median']:.3f}; "
        f"the profiled step's bytes bound {bound:.3f} ms: weights and "
        f"{kv_positions} K/V positions per layer over {PEAK_BYTES_PER_S / 1e12} TB/s), "
        f"{rec['decode_tokens_per_s']:.1f} tokens/s in the decode loop; the profiled step's "
        f"{profile['busy_us']:.1f} us of device time in the mean unprofiled step's "
        f"{step_us:.1f} us: idle share {rec['decode_idle_share']:.3f}; K4 {k4_us:.1f} us "
        f"of it ({rec['profile_k4_share']:.3f}) in {k4_profile_launches} launches")
    return [rec], counts


def profile_query(torch, label, fn, top: int = 8, warm: bool = True) -> dict:
    """One query under torch.profiler (after one unprofiled call when
    ``warm``): device busy time against the host wall clock, and the
    kernels that take the device time.  Returns wall and busy microseconds
    and the device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
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
    for e in kernels:
        if any(k in e.key for k in PORT_KERNELS):
            log(f"  port kernel {e.key[:60]}: {e.self_device_time_total:.1f} us in "
                f"{e.count} launches, {e.self_device_time_total / busy_us:.3f} of device busy")
    return dict(wall_us=wall_us, busy_us=busy_us,
                by_kernel={e.key: e.self_device_time_total for e in kernels},
                count_by_kernel={e.key: e.count for e in kernels})


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
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, launch_counts, ops, reset_launch_counts
    from repro_torch.kernels import decode_attention as k4
    from repro_torch.models.transformer import init_lm
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
    with ThreadPoolExecutor(len(KERNEL_STEMS) + 1) as pool:  # one nvcc per source
        earlier = pool.submit(build_parent, args.compare) if args.compare else None
        list(pool.map(build.compile_source, KERNEL_STEMS))
        parent = earlier.result() if earlier else None
    for stem in KERNEL_STEMS:
        build.library(stem)
    log(f"build: {', '.join(s + '.cu' for s in KERNEL_STEMS)} in "
        f"{time.perf_counter() - t0:.2f} s")
    ptxas = {stem: dict(ptxas_report(build.BUILD_LOG.get(stem, ""))) for stem in KERNEL_STEMS}
    for stem, report in ptxas.items():
        for name, regs in report.items():
            log(f"  nvcc {stem}: {name}: {regs}")

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
    layouts = {}
    for name, g in graphs.items():
        t_lo, t_hi = int(g.t_start.min()), int(g.t_end.max())
        layouts[name] = (g, plan_query(g, None, (t_lo, t_hi), backend="pallas_tiled"))
    g, plan = layouts["power_law"]
    t_lo, t_hi = int(g.t_start.min()), int(g.t_end.max())
    rows = kernel_phases(torch, np, g, plan, (t_hi - (t_hi - t_lo) // 50, t_hi),
                         args.seed, tem, segments_for,
                         parent_for(parent, "segment_min_tiles_launch"))
    rows.append(spmm_phases(torch, np, layouts, args.seed, spmm, ops, segments_for,
                            parent_for(parent, "segment_spmm_tiles_launch")))

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
        records += paths_path(torch, np, name, g, tger, fields, windows, sources)
    # multi-tenant serving and the ring streams (counted too)
    records += serving_path(torch, np, "power_law", graphs["power_law"],
                            contexts["power_law"][0], contexts["power_law"][1], failures)
    for name, access in (("transit", "index"), ("power_law", "hybrid")):
        tger, fields, _, _ = contexts[name]
        records += ring_stream(torch, np, name, graphs[name], tger, fields, access)
    counts = launch_counts()
    log(f"graph paths launches: {counts}")
    # -- the frontier ladder, counted on its own ------------------------------
    reset_launch_counts()
    ladder_records, laddered_k1 = ladder_path(torch, np, graphs, contexts, failures, tem)
    ladder_counts = launch_counts()
    log(f"ladder phase launches: {ladder_counts}")
    if ladder_counts["segment_min_tiles"] <= 0:
        raise AssertionError("K1 was never launched in the ladder phase")
    records += ladder_records
    if failures:
        raise AssertionError(f"{len(failures)} checks failed:\n" + "\n".join(failures))

    # -- K4 at the LM's decode shape; the LM serving path, counted ------------
    cfg = get_arch(LM_ARCH).cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 2)
    rows.append(decode_phases(torch, np, cfg, gen, k4,
                              parent_for(parent, "decode_attention_launch")))
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    model = init_lm(cfg, gen, "cuda")
    torch.cuda.synchronize()
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads / {cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}; {cfg.n_params} parameters; init from seed {args.seed} "
        f"in {time.perf_counter() - t0:.2f} s")
    lm_records, lm_counts = lm_path(torch, np, model, args.seed)
    del model
    records += lm_records
    counts["decode_attention"] = lm_counts["decode_attention"]
    # the kernels' instances on the main paths: registers, spills
    for row in rows[:2]:  # K1: its one-window and its windowed instance
        row["ptxas"] = {k: v for k, v in ptxas["temporal_edgemap"].items()
                        if k.startswith(f"{row['name']}_kernel")}
    rows[2]["ptxas"] = ptxas["segment_spmm"].get("segment_spmm_tiles_kernel")
    rows[3]["ptxas"] = {f"<{t}, G={G}>": ptxas["decode_attention"].get(
        f"decode_attention_kernel<{t}, {v}, {G}>") for t, v in (("bf16", 8), ("f32", 4))
        for G in (cfg.n_heads // cfg.n_kv_heads,)}
    for row in rows:
        row["ladder_launches"] = ladder_counts[row["name"]]
        row["launches"] = counts[row["name"]] + row["ladder_launches"]
        if row["name"] == "segment_min_tiles":
            row["launches_in_laddered_solves"] = laddered_k1
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched on its path")
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
