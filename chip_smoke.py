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
6. The cold store and the daemon, their launch counts read around them:
   a ``ColdStore`` under the transit index ring stream (through
   ``GraphBatchServer``; the store's watermark on the ring's low watermark
   and the rows equal to cold sweeps after every advance; the backfill and
   each advance's compaction timed on the host), time travel over an
   evicted and a split window (rows equal to the full-history index solve,
   the stitched view equal to ``index_ring_view``, the hot chain still a
   delta), again through a store spilled to disk; the daemon on power-law
   scan/pallas_tiled (``run_daemon``'s tenants and churn, betweenness in a
   class of its own: every served tenant against a cold solve, the
   round-robin, K1 every tick and K3 in PageRank's; one tick profiled);
   ``run_daemon --history-chunks 1024`` on transit with a pinned CC
   tenant (its rows the full-history solve on every tick, its repeat
   serve a noop).
7. Distributed serving and the edge-partitioned engine on NCCL, their
   launch counts read around them: a process group of one rank in this
   process; on both graphs the distributed EA from the context's four
   sources (scan, the index budget on per-shard sorted edges, the top-K
   exchange) on the narrow and wide windows, bit-identical to
   ``earliest_arrival`` and timed per query and per round, PageRank rounds
   against a float64 oracle and CC rounds to labels equal to
   ``temporal_cc``; ``serving_path``'s batch with ``mesh=1`` in turns with
   the unsharded chain (rows equal, K1 and K3 inside every sharded
   advance, one advance profiled with its NCCL kernels apart); then
   ``launch/serve.py --daemon --shard-queries 1`` under ``torchrun`` as a
   subprocess (exit 0), and, on a machine with more cards, the engine and
   the sharded serving on min(cards, 4) spawned NCCL ranks.
8. K4 (flash-decode attention) at phi4-mini-3.8b's decode shape (8 rows,
   2048 positions, ragged lengths, GQA group 3, d_head 128) in bfloat16 and
   float32 against its plain version, timed beside it, beside
   scaled_dot_product_attention and beside its bytes bound: warm (one set of
   caches), and in bfloat16 cold (four sets in turn, past the L2) at those
   lengths and at serving lengths (16-576).  With ``--compare DIR``, the
   kernels of each source present in DIR (``temporal_edgemap.cu``,
   ``segment_spmm.cu``, ``decode_attention.cu``: the kernels before their
   redesign) are built and timed in turns with these (old, new, new, old).
9. LM continuous batching at phi4-mini-3.8b's published widths (32 layers,
   bfloat16, random weights from ``--seed``): a ServeEngine of 8 slots x
   2048 positions serves 16 seeded requests (prompts of 16-512 tokens,
   budgets up to 64, one of 1 and one of 0), with launch counts reset just
   before and read just after (K4 launches = 32 x decode steps); layer 0
   of the engine's own decode steps and every served token are checked
   against ``forward``; prefill and decode times, tokens/s and a profile of
   one decode step are printed.
10. MoE at qwen3-moe-30b-a3b's published widths (d_model 2048, 128 experts,
   top-8, expert d_ff 768, vocab 151936, bfloat16): ``moe_ffn`` against a
   per-token dense mixture (float32); K4 at its decode shape (G 8); item 9's
   serving run on 4 layers at capacity factor 16 (nothing dropped, so the
   served tokens check against ``forward``), launch counts reset just
   before and read just after (K4 launches = 4 x decode steps); 8 train
   steps on 2 layers (losses finite and falling); every decode block in
   bfloat16 held to the dense criterion (``LM_LAYER_TOL``), as MoE routing
   breaks exact ties by expert id.
11. LM training through ``launch/train.py`` at smollm-135m's published
   config (30 layers, bfloat16, batch 8 x 512): 40 steps with a checkpoint
   every 20, then a fresh run resumed from step 20, both under
   ``torch.use_deterministic_algorithms`` (resumed losses equal to the
   uninterrupted ones, losses falling); int8, top-k and 2-microbatch runs;
   one float32 step on the card against the CPU and 2 microbatches against
   one batch (2 layers); ms per step, tokens/s, peak memory and a profiled
   step's idle share.
12. The paper's cells (``configs/kairos.py``'s six KAIROS_CELLS), launch
   counts read around them (K1–K4 launch 0 times: the reference runs no
   Pallas kernel there): |V| = 1e7, |E| = 1e9 drawn on the card from
   ``--seed`` with ``synthetic_temporal_graph``'s distributions (start-time
   gaps Poisson(1), not 2, so end times stay in int32) and sorted per
   shard by time, then the distributed engine on a one-rank NCCL group:
   ``ea_selective_1b`` (128 sources, a window of at most 2^17 edges)
   against numpy on the window's edges, ``ea_selsparse_1b`` and
   ``ea_scan_1b`` (2 sources: cut from 128) equal to it, ``ea_scan_1b`` and
   ``ea_sparse_1b`` on a wide window (the EA equation at seeded sampled
   vertices, numpy on their in-edges; sparse equal to scan), ``cc_1b``
   (round 1 against numpy at the sampled vertices, then the fixpoint's
   labels checked along every edge) and ``pagerank_1b`` (rounds against a
   float64 numpy oracle at the sampled vertices): ms per round and per
   warm query, a profiled selective query and CC round; then
   ``KairosFamily.smoke`` on the card.
13. The GNN, NequIP and MIND models at their published widths, launch
   counts read around them (0 again): graphsage-reddit at minibatch_lg (a
   graph of Reddit's shape, 232,965 vertices and 114,615,892 edges, 602
   features, from ``--seed``; ``NeighborSampler`` fanout (15, 10), 1,024
   seeds, padded to 169,984 nodes; one float32 step from the initial
   weights on the card against the CPU, then 10 AdamW steps: host
   sampling and device ms, a profiled step's idle share and
   ``index_add``'s share); gcn-cora at full_graph_sm and gin-tu at
   molecule (20 steps each); nequip at molecule (128 x 30 atoms, 5
   layers, 32 channels, l_max 2: energy-MSE steps, energies invariant and
   forces equivariant under a seeded rotation); mind with its 1e8 x 64
   table (serve_p99 at B 512, retrieval_cand over 1e6 candidates: the ids
   equal a stable sort of the same scores on the CPU) and train_batch
   (65,536 users) on a table cut to 1e7 rows.
14. Sharded training on a one-rank NCCL group's (1, 1) ``("data",
   "model")`` DTensor mesh, launch counts read around it (0: no kernel on
   the path): one step of qwen3-moe at 4 layers (SGD) with DTensor
   parameters against its unsharded step; smollm-135m at its published
   config, 6 steps with DTensor parameters and AdamW state in turns with
   the same steps unsharded (losses, gradient norms and parameters held to
   ``TRAIN_TOL``; ms a step, peak memory, a profiled sharded step's idle
   share); a sharded checkpoint restored onto the (1, 1) mesh of a fresh
   process group with ``shardings=``, its next 3 losses equal to the
   uninterrupted run's.
15. The examples (``examples/*_torch.py``) on the card against their
   ``--device cpu`` runs, launch counts read around them: the quickstart,
   contact tracing, the distributed example under ``torchrun`` (one NCCL
   rank) against 8 gloo ranks, LM serving (K4 must launch), the trainer's
   200 steps and 5 steps from CPU-drawn weights against the CPU's.
16. Prints the kernel table as one JSON line (each kernel's launches on
   the counted paths of items 4–7, 9, 10 and 15, the ladder phase's, the
   history/daemon phase's, the distributed phase's, the MoE serving
   phase's, the training phase's, the Kairos, the models, the sharded
   training and the examples phases' also apart, K4 at the MoE decode
   shape, and K1's launches inside laddered solves), then the result line.  Each phase logs its wall time and its
   peak device memory.

Any mismatch raises, and the script exits non-zero.  It imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
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
# For a MoE model the bfloat16 teacher-forced check requires the written
# K/V and the median block only: a router score near the top-k boundary
# rounds either way in bfloat16 and the block then mixes another expert
# (the float32 check still requires every block).
# LM training through launch/train.py at smollm-135m's published config
# (30 layers, d_model 576, vocab 49152, bfloat16)
TRAIN_ARCH = "smollm-135m"
TRAIN_STEPS, TRAIN_CKPT_EVERY = 40, 20
TRAIN_BATCH, TRAIN_SEQ = 8, 512
# The reference's init gives smollm's logits a spread of ~24 at these widths
# (first loss ~101, gradient norm ~7e10): at the trainer's default rate
# 3e-3 the bfloat16 weights barely move in 40 steps and the loss stays flat
# (an H100 80GB HBM3 at 700 W), at 3e-2 it falls (~101 -> ~77 in 24 steps
# on the CPU)
TRAIN_LR = 3e-2
TRAIN_SHORT_STEPS = 3
TRAIN_TIMED_STEPS = 10
# One train step on the card in float32 (one batch, and 2 microbatches)
# against the CPU's float64 step, and the CPU's float32 step beside it, TF32
# off: smollm's widths at TRAIN_CMP_LAYERS layers, AdamW at a constant rate.
# At these widths float32 itself puts the gradients ~2e-3 (relative L2) off
# float64 on the CPU, in every leaf (the reference's init makes the
# attention softmax nearly one-hot; an H100 80GB HBM3 read 1.3e-3 between
# the card and the CPU), so the card's gradients are held to within
# 2x the CPU's float32 error; the loss within rtol 1e-5 and the gradient
# norm within 1e-4 of float64; every parameter within 2.5 lr of the CPU's
# float32 step (a first AdamW step moves an entry by about lr x sign(g): an
# entry whose gradient rounds to the other sign lands up to 2 lr away).
TRAIN_CMP_LAYERS = 2
TRAIN_CMP_BATCH, TRAIN_CMP_SEQ = 4, 128
TRAIN_CMP_LR = 3e-3
TRAIN_TOL = dict(loss_rel=1e-5, grad_norm_rel=1e-4, grads_rel_l2_over_cpu=2.0,
                 params_gap_lr=2.5)
# MoE at qwen3-moe-30b-a3b's published widths (d_model 2048, 128 experts,
# top-8, expert d_ff 768, vocab 151936), depth cut to 4 layers for serving
# and 2 for training.  Serving runs at capacity factor E / K = 16, so
# C >= T and no pair is dropped: at a decode step T is the slot count, in
# forward the sequence length, and a tight capacity would drop different
# pairs in the two.
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 4, 2
MOE_AMPLE = 16.0
MOE_FFN_TOKENS = 64
MOE_FFN_TOL = dict(rtol=2e-4, atol=2e-4)  # test_models.py's dense-mixture check
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 256, 8


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


def pagerank_oracle(np, src, dst, ts, te, n_v, window, n_iters, damping=0.85,
                    dangling=True):
    """Vectorised float64 numpy PageRank over the window-valid edges
    (``dangling=False``: the distributed round's, whose dangling vertices'
    mass is not spread)."""
    ok = (ts >= window[0]) & (te <= window[1])
    s, d = src[ok], dst[ok]
    out_deg = np.bincount(s, minlength=n_v).astype(np.float64)
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1.0), 0.0)
    sinks = out_deg == 0
    pr = np.full(n_v, 1.0 / n_v)
    for _ in range(n_iters):
        agg = np.bincount(d, weights=(pr * inv)[s], minlength=n_v)
        spread = pr[sinks].sum() / n_v if dangling else 0.0
        pr = (1 - damping) / n_v + damping * (agg + spread)
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
            if alg == "betweenness":   # float sums: analytics_path's tolerance
                a, b = to_numpy(res[qi]), to_numpy(want[col[r.window]])
                scale = max(float(np.abs(b).max()), 1.0)
                if not np.abs(a.astype(np.float64) - b).max() <= 1e-5 * scale:
                    raise AssertionError(f"[{name}] serving advance {step}: betweenness "
                                         f"row {qi} off the cold sweep")
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


def ring_batches(np, fields):
    """The ring streams' tenant batch: ``batch_at(base)`` is EA from
    RING_SOURCES sources active in the last span/50 over SERVE_WINDOWS
    sliding windows of span/50 ending at ``base``; returns it with the cold
    start's base, the stride and the sources."""
    from repro_torch.engine import QueryBatch, QuerySpec
    from repro_torch.serve import sliding_windows

    src_np, _, ts_np, te_np = fields
    t_hi = int(te_np.max())
    width = (t_hi - int(ts_np.min())) // 50
    stride = width // 4
    active = np.unique(src_np[ts_np >= t_hi - width])
    srcs = [int(active[len(active) // 3]), int(active[2 * len(active) // 3])]

    def batch_at(base):
        return QueryBatch.make([QuerySpec.make("earliest_arrival", tuple(int(x) for x in w),
                                               sources=srcs)
                                for w in sliding_windows(base, width, stride,
                                                         SERVE_WINDOWS)])

    return batch_at, t_hi - (RING_ADVANCES + 1) * stride, stride, srcs


def ring_stream(torch, np, name, g, tger, fields, access):
    """An index or hybrid ring stream: EA from RING_SOURCES sources over
    SERVE_WINDOWS narrow windows, RING_ADVANCES one-stride advances.  After
    each, the advanced ring equals a cold ring build at its (lo, hi) field
    for field, the rows equal cold sweeps, and the log reads
    ``fused:<access>``."""
    from repro_torch.core.edgemap import hybrid_ring_view, index_ring_view
    from repro_torch.serve import dispatch_log, serve_batch, sweep

    sync = torch.cuda.synchronize
    build = index_ring_view if access == "index" else hybrid_ring_view
    batch_at, base, stride, srcs = ring_batches(np, fields)
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


# the tiered-history and daemon phase: run_daemon's tenant mix and churn
DAEMON_TENANTS = 16
DAEMON_TICKS = 12
HISTORY_TICKS = 8
DAEMON_ARRIVALS, DAEMON_DEPARTURES = 0.5, 0.25   # run_daemon's default rates
DAEMON_ALGORITHMS = ("earliest_arrival", "reachability", "bfs", "cc", "pagerank")
DAEMON_PAGERANK_ITERS = 8


def host_timed(obj, method):
    """Replace ``obj.<method>`` by a wrapper that appends (host ms, result)
    of every call to the returned list."""
    fn, calls = getattr(obj, method), []

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        calls.append(((time.perf_counter() - t0) * 1e3, out))
        return out

    setattr(obj, method, wrapper)
    return calls


def daemon_spec(n_vertices, width, i):
    """run_daemon's tenant ``i``: the five algorithms in turn over a window
    of ``width`` (re-anchored every tick), sources 7 i mod V."""
    from repro_torch.engine import QuerySpec

    alg = DAEMON_ALGORITHMS[i % len(DAEMON_ALGORITHMS)]
    if alg == "cc":
        return QuerySpec.make(alg, (0, width))
    if alg == "pagerank":
        return QuerySpec.make(alg, (0, width), n_iters=DAEMON_PAGERANK_ITERS)
    return QuerySpec.make(alg, (0, width), sources=(7 * i) % n_vertices)


def history_ring(torch, np, name, g, tger, fields):
    """The cold store under the index ring stream (``ring_batches``, a cold
    start and RING_ADVANCES advances through ``GraphBatchServer``): the
    store's watermark on the ring's low watermark and rows equal to cold
    sweeps after every advance; the first note's backfill and each
    advance's compaction timed on the host.  Then time travel: an evicted
    and a split window (EA from the stream's sources and CC) through the
    cold tier, rows equal to a cold full-history index solve and the
    stitched view equal to ``index_ring_view``, the hot chain unconsumed;
    then the same through a store spilled to disk."""
    import tempfile

    from repro_torch.core import ColdStore
    from repro_torch.core.edgemap import index_ring_view
    from repro_torch.device import to_numpy
    from repro_torch.engine import QueryBatch, QuerySpec
    from repro_torch.serve import GraphBatchServer, dispatch_log, serve_batch, sweep

    sync = torch.cuda.synchronize
    cs = ColdStore(g, tger)
    mirrors, notes = host_timed(cs, "_mirrors"), host_timed(cs, "note_eviction")
    server = GraphBatchServer(g, tger, access="index", coldstore=cs)
    batch_at, base, stride, srcs = ring_batches(np, fields)
    records, advance_ms = [], []

    def advance(step):
        batch = batch_at(base + step * stride)
        n_notes = len(notes)
        sync()
        t0 = time.perf_counter()
        with dispatch_log() as tags:
            rows = server.advance(batch)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        state = server.state
        want = ("cold", ["cold:view", "cold:solve"]) if step == 0 else (
            "delta", ["fused:index"])
        if (state.last_advance, tags) != want:
            raise AssertionError(f"[{name}] history ring advance {step}: "
                                 f"{state.last_advance} {tags}, expected {want}")
        if cs.watermark != state.lo:
            raise AssertionError(f"[{name}] history ring advance {step}: the cold "
                                 f"store's watermark {cs.watermark} is not the ring's "
                                 f"low watermark {state.lo}")
        wins = np.asarray(sorted({r.window for r in batch.rows()}), np.int32)
        col = {tuple(int(x) for x in w): i for i, w in enumerate(wins)}
        colds = {s: to_numpy(sweep(g, s, wins, tger, plan=state.plan)) for s in srcs}
        for qi, r in enumerate(batch.groups()[("earliest_arrival", ())]):
            if not (rows[0][qi] == colds[r.source][col[r.window]]).all():
                raise AssertionError(f"[{name}] history ring advance {step}: row {qi} "
                                     f"differs from the cold sweep")
        return ms, sum(n[0] for n in notes[n_notes:])

    ms, note_ms = advance(0)
    st = cs.stats()
    backfill = dict(mirrors_ms=mirrors[0][0], seal_ms=note_ms - mirrors[0][0],
                    chunks=st["n_chunks"], positions=notes[0][1])
    log(f"[{name}] cold store backfill (first note, inside the cold start's "
        f"{ms:.3f} ms): {backfill['positions']} positions, mirrors "
        f"{backfill['mirrors_ms']:.3f} ms (one device-to-host copy), seal "
        f"{backfill['seal_ms']:.3f} ms for {backfill['chunks']} chunks")
    records.append(dict(graph=name, algorithm="coldstore_backfill", cold_start_ms=ms,
                        **backfill))
    for step in range(1, RING_ADVANCES + 1):
        ms, note_ms = advance(step)
        advance_ms.append(ms)
        log(f"[{name}] history ring advance {step}: delta ['fused:index'], {ms:.3f} ms, "
            f"compaction {note_ms:.3f} ms of host (watermark {cs.watermark}, "
            f"{cs.n_chunks} chunks, {cs.pending_slots} pending); rows equal to cold "
            f"sweeps")
        records.append(dict(graph=name, algorithm="history_ring", step=step, ms=ms,
                            compaction_ms=note_ms, watermark=cs.watermark))
    st = cs.stats()
    log(f"[{name}] cold store: {st['n_chunks']} chunks, {st['sealed_slots']} sealed "
        f"slots, compaction {st['compaction_ratio']:.3f}x, {st['nbytes']} bytes "
        f"(raw {st['raw_nbytes']})")
    records.append(dict(graph=name, algorithm="coldstore_stats", **st))

    # -- time travel ----------------------------------------------------------
    src_np, _, ts_np, te_np = fields
    t_min = int(ts_np.min())
    span = int(te_np.max()) - t_min
    width = span // 50
    t_wm = int(to_numpy(tger.start_sorted)[cs.watermark])
    travel = {"cold": (t_min + span // 8, t_min + span // 8 + width),
              "split": (t_wm - width // 2, t_wm + width // 2)}
    stitched = {}
    stitches = host_timed(cs, "ring_stitch")
    for kind, w in travel.items():
        hist = QueryBatch.make([QuerySpec.make("earliest_arrival", w, sources=srcs),
                                QuerySpec.make("cc", w)])
        hot = server.state
        sync()
        t0 = time.perf_counter()
        with dispatch_log() as tags:
            res, hstate = serve_batch(g, hist, tger, state=hot, access="index",
                                      coldstore=cs)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        stitch_ms = stitches[-1][0]
        if hstate.plan.tier != kind or tags[0] != "cold:stitch" or hot.consumed:
            raise AssertionError(f"[{name}] time travel {kind}: tier {hstate.plan.tier}, "
                                 f"{tags}, hot state consumed {hot.consumed}")
        ref, _ = serve_batch(g, hist, tger, plan=hstate.plan)   # full history, on card
        for gi, (a, b) in enumerate(zip(res, ref)):
            if not torch.equal(a, b):
                raise AssertionError(f"[{name}] time travel {kind}: group {gi} differs "
                                     f"from the cold full-history index solve")
        ring = index_ring_view(g, tger, hstate.lo, hstate.hi, capacity=hstate.capacity)
        if not all(torch.equal(a, b) for a, b in zip(hstate.edges, ring)):
            raise AssertionError(f"[{name}] time travel {kind}: the stitched view "
                                 f"differs from index_ring_view")
        stitched[kind] = (hist, hstate.edges, res)
        log(f"[{name}] time travel {kind} {w}: {ms:.3f} ms ({stitch_ms:.3f} ms stitch on "
            f"the host, {ms - stitch_ms:.3f} ms view upload and solve), positions "
            f"[{hstate.lo}, {hstate.hi}) in {hstate.capacity} slots, {tags[0]}; rows "
            f"equal to the full-history solve, view equal to index_ring_view")
        records.append(dict(graph=name, algorithm=f"time_travel_{kind}", ms=ms,
                            stitch_ms=stitch_ms, positions=hstate.hi - hstate.lo,
                            capacity=hstate.capacity))
    with dispatch_log() as tags:
        server.advance(batch_at(base + (RING_ADVANCES + 1) * stride))
    if server.state.last_advance != "delta" or tags != ["fused:index"]:
        raise AssertionError(f"[{name}] the hot chain after time travel: "
                             f"{server.state.last_advance} {tags}")
    log(f"[{name}] the hot chain after time travel: delta {tags}")

    # -- the same through a store spilled to disk -------------------------------
    with tempfile.TemporaryDirectory() as spill:
        cs2 = ColdStore(g, tger, spill_dir=spill)
        t0 = time.perf_counter()
        cs2.note_eviction(cs.watermark)
        seal_ms = (time.perf_counter() - t0) * 1e3
        for kind, (hist, edges, res) in stitched.items():
            sync()
            t0 = time.perf_counter()
            res2, h2 = serve_batch(g, hist, tger, access="index", coldstore=cs2)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            if not (all(torch.equal(a, b) for a, b in zip(h2.edges, edges))
                    and all(torch.equal(a, b) for a, b in zip(res2, res))):
                raise AssertionError(f"[{name}] spilled time travel {kind} differs")
            records.append(dict(graph=name, algorithm=f"time_travel_{kind}_spilled",
                                ms=ms))
            log(f"[{name}] spilled time travel {kind}: {ms:.3f} ms, stitch and rows "
                f"equal to the in-memory store's")
        st2 = cs2.stats()
        if st2["spilled_chunks"] <= 0:
            raise AssertionError(f"[{name}] the spilled store spilled no chunk")
        log(f"[{name}] spilled store: {st2['spilled_chunks']} chunks written in "
            f"{seal_ms:.3f} ms (mirrors included)")
        records.append(dict(graph=name, algorithm="coldstore_spill", seal_ms=seal_ms,
                            spilled_chunks=st2["spilled_chunks"]))
    return records


def daemon_tiled(torch, np, name, g, tger, fields, sources, failures, seed):
    """The daemon on scan/pallas_tiled: run_daemon's tenant mix (width
    span/80, stride width/8, PageRank at DAEMON_PAGERANK_ITERS) plus one
    betweenness tenant in a cost class of its own, so two deep classes
    alternate; DAEMON_TENANTS resident tenants, DAEMON_TICKS ticks with
    Poisson churn from ``seed``.  Every served tenant's rows against a cold
    solve of its re-anchored window under its class's plan, the deep
    round-robin, K1 in every tick (the cheap class) and K3 in every tick
    that serves PageRank's class; then one tick profiled."""
    import dataclasses

    from repro_torch.engine import DEFAULT_COST_CLASS, QueryBatch, QuerySpec
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import GraphBatchServer, dispatch_log

    sync = torch.cuda.synchronize
    _, _, ts_np, te_np = fields
    t_max = int(te_np.max())
    width = max((int(ts_np.max()) - int(ts_np.min())) // 80, 1)
    stride = max(width // 8, 1)
    t_base = t_max - (DAEMON_TICKS + 3) * stride
    rng = np.random.default_rng(seed)
    server = GraphBatchServer(g, tger, access="scan", backend="pallas_tiled")
    live = [server.submit(daemon_spec(g.n_vertices, width, i))
            for i in range(DAEMON_TENANTS)]
    live.append(server.submit(QuerySpec.make(
        "betweenness", (0, width), sources=sources[:2], cost_class="betweenness")))
    n_spawned, last_deep, records, tick_ms = DAEMON_TENANTS, None, [], []
    for k in range(DAEMON_TICKS):
        before, solved0 = launch_counts(), server.stats.rows_solved
        served0 = server.stats.rows_served
        t_now = t_base + k * stride
        sync()
        t0 = time.perf_counter()
        with dispatch_log() as tags:
            rep = server.tick(t_now)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        tick_ms.append(ms)
        after = launch_counts()
        k1 = after["segment_min_tiles"] - before["segment_min_tiles"]
        k3 = after["segment_spmm_tiles"] - before["segment_spmm_tiles"]
        tenants = server.tenants
        deep = sorted({s.resolved_cost_class for s in tenants.values()}
                      - {DEFAULT_COST_CLASS})
        nxt = [c for c in deep if last_deep is None or c > last_deep]
        want = (DEFAULT_COST_CLASS,) + (((nxt or deep)[0],) if deep else ())
        if rep.classes_served != want:
            raise AssertionError(f"[{name}] daemon tick {k}: served "
                                 f"{rep.classes_served}, the round-robin says {want}")
        last_deep = want[-1] if deep else last_deep
        if k1 <= 0 or ("deep" in rep.classes_served and k3 <= 0):
            raise AssertionError(f"[{name}] daemon tick {k} ({rep.classes_served}): "
                                 f"K1 {k1}, K3 {k3} launches")
        for tid, got in rep.results.items():
            spec = tenants[tid]
            w = int(spec.window[1]) - int(spec.window[0])
            inst = dataclasses.replace(spec, window=(t_now - w, t_now))
            plan = server._class_states[spec.resolved_cost_class].plan
            res = tuple(torch.as_tensor(x, device=g.device)
                        for x in (got if isinstance(got, tuple) else (got,)))
            _batch_rows_vs_cold(torch, np, name, g, tger, QueryBatch.make([inst]),
                                (res if len(res) > 1 else res[0],), plan, failures,
                                f"daemon tick {k} tenant {tid}")
        rows = server.stats.rows_served - served0
        solved = server.stats.rows_solved - solved0
        class_ms = {c: t * 1e3 for c, t in zip(
            rep.classes_served, server.latencies[-len(rep.classes_served):])}
        log(f"[{name}] daemon tick {k}: {ms:.3f} ms ("
            + ", ".join(f"{c} {t:.3f}" for c, t in class_ms.items()) + "), "
            f"classes {list(rep.classes_served)}, "
            f"{rows} rows served ({solved} solved), {tags.count('rebucket')} rebucket, "
            f"K1 {k1} / K3 {k3} launches, admitted {len(rep.admitted)} retired "
            f"{len(rep.retired)}; rows equal to cold solves")
        records.append(dict(graph=name, algorithm="daemon_tick", step=k, ms=ms,
                            class_ms=class_ms, rows=rows, solved=solved,
                            rebuckets=tags.count("rebucket"), k1_launches=k1,
                            k3_launches=k3))
        for _ in range(rng.poisson(DAEMON_ARRIVALS)):
            live.append(server.submit(daemon_spec(g.n_vertices, width, n_spawned)))
            n_spawned += 1
        for _ in range(rng.poisson(DAEMON_DEPARTURES)):
            if len(live) > 1:
                server.retire(live.pop(int(rng.integers(len(live)))))
    lat = np.asarray(server.latencies) * 1e3
    s = server.stats
    log(f"[{name}] daemon: {s.ticks} ticks, {s.advances} class serves ({s.cold_advances} "
        f"cold), {s.admissions} admissions / {s.retirements} retirements, per-class "
        f"latency p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms")
    records.append(dict(graph=name, algorithm="daemon_summary", ticks=s.ticks,
                        class_serves=s.advances, cold=s.cold_advances,
                        admissions=s.admissions, retirements=s.retirements,
                        class_p50_ms=float(np.percentile(lat, 50)),
                        class_p99_ms=float(np.percentile(lat, 99))))
    prof = profile_query(torch, f"[{name}] daemon tick", lambda: server.tick(
        t_base + DAEMON_TICKS * stride), warm=False)
    records.append(idle_record(np, name, "daemon_tick_profile", prof, tick_ms,
                               unit="tick"))
    return records


def daemon_history(torch, np, name, g, tger, fields, seed):
    """run_daemon with ``--history-chunks 1024`` on an index plan:
    HISTORY_TICKS ticks of run_daemon's tenants and churn, a pinned CC
    tenant at t_min + span/8 submitted at tick HISTORY_TICKS // 2; its rows
    identical on every later tick, equal to a cold full-history index
    solve, its window never re-anchored, its repeat serve the noop path."""
    from repro_torch.core import ColdStore
    from repro_torch.device import to_numpy
    from repro_torch.engine import QueryBatch, QuerySpec
    from repro_torch.serve import GraphBatchServer, serve_batch

    sync = torch.cuda.synchronize
    _, _, ts_np, te_np = fields
    t_min, t_max = int(ts_np.min()), int(te_np.max())
    span = int(ts_np.max()) - t_min
    width = max(span // 80, 1)
    stride = max(width // 8, 1)
    t_base = t_max - (HISTORY_TICKS + 2) * stride
    rng = np.random.default_rng(seed)
    cs = ColdStore(g, tger, chunk_slots=1024)
    notes = host_timed(cs, "note_eviction")
    server = GraphBatchServer(g, tger, access="index", coldstore=cs)
    live = [server.submit(daemon_spec(g.n_vertices, width, i))
            for i in range(DAEMON_TENANTS)]
    n_spawned, records = DAEMON_TENANTS, []
    hist = (t_min + span // 8, t_min + span // 8 + width)
    pinned = ref = None
    for k in range(HISTORY_TICKS):
        n_notes = len(notes)
        sync()
        t0 = time.perf_counter()
        rep = server.tick(t_base + k * stride)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        note_ms = sum(n[0] for n in notes[n_notes:])
        msg = ""
        if pinned is not None:
            hstate = server._class_states[server.HISTORY_CLASS]
            got = rep.results[pinned]
            if ref is None:
                ref = to_numpy(serve_batch(g, QueryBatch.make([QuerySpec.make("cc", hist)]),
                                           tger, plan=hstate.plan)[0][0])
                want_advance = "cold"
            else:
                want_advance = "noop"
            if not ((got == ref).all() and hstate.last_advance == want_advance
                    and tuple(hstate.group_windows[0][0]) == hist
                    and hstate.plan.tier == "cold"):
                raise AssertionError(f"[{name}] history daemon tick {k}: the pinned "
                                     f"tenant's {hstate.last_advance} serve "
                                     f"(tier {hstate.plan.tier}) is not the full-history "
                                     f"solve of {hist}")
            msg = (f"; pinned CC {hist} {hstate.last_advance} ({hstate.plan.tier} tier), "
                   f"rows equal to the full-history solve")
        class_ms = {c: t * 1e3 for c, t in zip(
            rep.classes_served, server.latencies[-len(rep.classes_served):])}
        log(f"[{name}] history daemon tick {k}: {ms:.3f} ms (compaction {note_ms:.3f} ms "
            f"of host; " + ", ".join(f"{c} {t:.3f}" for c, t in class_ms.items())
            + f"), watermark {cs.watermark}" + msg)
        records.append(dict(graph=name, algorithm="history_daemon_tick", step=k, ms=ms,
                            compaction_ms=note_ms, class_ms=class_ms))
        if k == HISTORY_TICKS // 2:
            pinned = server.submit(QuerySpec.make("cc", hist, pinned=True))
            live.append(pinned)
        for _ in range(rng.poisson(DAEMON_ARRIVALS)):
            live.append(server.submit(daemon_spec(g.n_vertices, width, n_spawned)))
            n_spawned += 1
        for _ in range(rng.poisson(DAEMON_DEPARTURES)):
            if len(live) > 1:
                tid = live.pop(int(rng.integers(len(live))))
                if tid == pinned:   # the pinned tenant stays to be checked
                    live.append(tid)
                else:
                    server.retire(tid)
    if ref is None:
        raise AssertionError(f"[{name}] history daemon: the pinned tenant never served")
    st = cs.stats()
    log(f"[{name}] history daemon: {server.stats.ticks} ticks, cold store "
        f"{st['n_chunks']} chunks, watermark {st['watermark']}, compaction "
        f"{st['compaction_ratio']:.3f}x")
    return records


def history_daemon_path(torch, np, graphs, contexts, failures, seed):
    """The cold store on the transit index ring with time travel, the
    daemon on power_law scan/pallas_tiled (K1 and K3), and the daemon with
    history on transit."""
    tger, fields, _, _ = contexts["transit"]
    records = history_ring(torch, np, "transit", graphs["transit"], tger, fields)
    tger, fields, _, sources = contexts["power_law"]
    records += daemon_tiled(torch, np, "power_law", graphs["power_law"], tger, fields,
                            sources, failures, seed)
    tger, fields, _, _ = contexts["transit"]
    records += daemon_history(torch, np, "transit", graphs["transit"], tger, fields, seed)
    return records


DIST_MAX_ROUNDS = 100_000  # the EA loops stop at their fixpoint
DIST_TOPK = 1 << 16        # the top-K exchange's budget per source row
DIST_PR_ROUNDS = 20
DIST_REPS = 3              # timed calls per distributed EA query (median)
DIST_DAEMON_TICKS = 4
DIST_MAX_RANKS = 4


def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_engine(torch, np, name, g, tger, fields, windows, sources, mesh):
    """The edge-partitioned engine on ``mesh``: distributed EA from the
    context's sources (scan; the index budget on per-shard sorted edges;
    the top-K exchange) equal bit for bit to ``earliest_arrival`` on the
    narrow and the wide window, timed per query and per round; PageRank
    rounds against the float64 oracle of the same round; CC rounds to their
    fixpoint against ``temporal_cc``'s labels."""
    from repro_torch.core.algorithms import earliest_arrival, temporal_cc
    from repro_torch.distributed import graph_engine as ge
    from repro_torch.engine.plan import make_plan, rung

    sync = torch.cuda.synchronize
    dev = g.src.device
    src_np, dst_np, ts_np, te_np = fields
    V, S = g.n_vertices, len(sources)
    edges = ge.shard_edges(mesh, g.src, g.dst, g.t_start, g.t_end)
    evalid = ge.shard_edges(mesh, torch.ones(g.n_edges, dtype=torch.bool, device=dev))[0]
    srt = ge.sort_edges_by_time_per_shard(mesh, *fields)
    srt_ts = srt[2].cpu().numpy()
    records = []
    for wname in ("narrow", "wide"):
        win = windows[wname]
        ref = torch.stack([earliest_arrival(g, s, win, tger) for s in sources])
        arr0 = torch.full((S, V), INF, dtype=torch.int32, device=dev)
        arr0[torch.arange(S, device=dev), torch.tensor(sources, device=dev)] = win[0]
        in_win = int(np.searchsorted(srt_ts, win[1], side="right")
                     - np.searchsorted(srt_ts, win[0], side="left"))
        for kind, plan, arrays, valid, srt_ok in (
                ("scan", None, edges, evalid, False),
                ("index", make_plan("index", budget=rung(max(in_win, 1))), srt[:4],
                 srt[4], True),
                ("topk", make_plan("scan", exchange_budget=DIST_TOPK), edges, evalid,
                 False)):
            times = []
            for _ in range(DIST_REPS):
                sync()
                t0 = time.perf_counter()
                out, rounds = ge.run_distributed_ea(
                    mesh, arr0, arrays, valid, win, max_rounds=DIST_MAX_ROUNDS,
                    plan=plan, edges_time_sorted=srt_ok, with_rounds=True)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(out, ref):
                raise AssertionError(f"[{name}] distributed EA {kind} {wname} differs "
                                     f"from earliest_arrival")
            ms = float(np.median(times))
            key = "" if plan is None else f" ({plan.cache_key})"
            log(f"[{name}] distributed EA {kind}{key} {wname}: {S} sources, {rounds} "
                f"rounds, {ms:.3f} ms per query (median of {DIST_REPS}: "
                f"{', '.join(f'{t:.3f}' for t in times)}), {ms / rounds:.3f} ms per "
                f"round; equal to earliest_arrival")
            records.append(dict(graph=name, algorithm=f"distributed_ea_{kind}",
                                window=wname, sources=S, rounds=rounds, ms=ms,
                                ms_per_round=ms / rounds, ms_all=times,
                                in_window_edges=in_win))
    win = windows["narrow"]
    ok = (g.t_start >= win[0]) & (g.t_end <= win[1])
    deg = torch.bincount(g.src[ok].long(), minlength=V).float()
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
    pr_round = ge.make_pagerank_round(mesh, V)
    pr = torch.full((V,), 1.0 / V, dtype=torch.float32, device=dev)
    sync()
    t0 = time.perf_counter()
    for _ in range(DIST_PR_ROUNDS):
        pr = pr_round(pr, *edges, evalid, inv, win)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    want = pagerank_oracle(np, src_np, dst_np, ts_np, te_np, V, win, DIST_PR_ROUNDS,
                           dangling=False)
    rel, l1 = pagerank_err(np, pr.cpu().numpy(), want)
    if not (rel <= PR_MAX_REL and l1 <= PR_L1):
        raise AssertionError(f"[{name}] distributed PageRank off its oracle: {rel:.3g}, "
                             f"L1 {l1:.3g}")
    log(f"[{name}] distributed PageRank narrow: {DIST_PR_ROUNDS} rounds in {ms:.3f} ms "
        f"({ms / DIST_PR_ROUNDS:.3f} ms per round); max |err| / max(pr) {rel:.3g}, "
        f"L1 {l1:.3g} against the float64 oracle")
    records.append(dict(graph=name, algorithm="distributed_pagerank", window="narrow",
                        rounds=DIST_PR_ROUNDS, ms=ms, ms_per_round=ms / DIST_PR_ROUNDS,
                        max_rel_err=rel, l1=l1))
    cc_round = ge.make_cc_round(mesh, V)
    labels = torch.arange(V, dtype=torch.int32, device=dev)
    sync()
    t0 = time.perf_counter()
    for rounds in range(1, DIST_MAX_ROUNDS + 1):
        new = cc_round(labels, *edges, evalid, win)
        if torch.equal(new, labels):
            break
        labels = new
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(labels, temporal_cc(g, win, tger)):
        raise AssertionError(f"[{name}] distributed CC labels differ from temporal_cc")
    log(f"[{name}] distributed CC narrow: {rounds} rounds in {ms:.3f} ms "
        f"({ms / rounds:.3f} ms per round); labels equal to temporal_cc")
    records.append(dict(graph=name, algorithm="distributed_cc", window="narrow",
                        rounds=rounds, ms=ms, ms_per_round=ms / rounds))
    return records


def dist_serving(torch, np, name, g, tger, fields, failures, mesh):
    """``serving_path``'s batch served twice in turns, unsharded and with
    ``mesh`` (scan/pallas_tiled): a cold start and SERVE_ADVANCES advances,
    integer rows bit-identical to the unsharded chain's, PageRank rows
    within the PageRank tolerance, K1 and K3 launched inside every sharded
    advance; then one sharded advance profiled (its NCCL time apart)."""
    from repro_torch.device import to_numpy
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import dispatch_log, serve_batch

    sync = torch.cuda.synchronize
    batch_at, base, stride = serving_stream(np, fields)
    n_d = int(mesh.size())
    st = {None: None, "mesh": None}
    records, sharded_ms = [], []
    for step in range(SERVE_ADVANCES + 1):
        batch = batch_at(base + step * stride)
        res, tags, ms, k = {}, {}, {}, {}
        for key in st:
            before = launch_counts()
            sync()
            t0 = time.perf_counter()
            with dispatch_log() as tags[key]:
                res[key], st[key] = serve_batch(
                    g, batch, tger, state=st[key], access="scan", backend="pallas_tiled",
                    mesh=None if key is None else mesh)
            sync()
            ms[key] = (time.perf_counter() - t0) * 1e3
            after = launch_counts()
            k[key] = {n: after[n] - before[n]
                      for n in ("segment_min_tiles", "segment_spmm_tiles")}
        want_tag = [] if step == 0 else [f"fused:scan@q{n_d}"]
        if step and tags["mesh"] != want_tag:
            raise AssertionError(f"[{name}] sharded advance {step} logged {tags['mesh']}")
        if min(k["mesh"].values()) <= 0:
            raise AssertionError(f"[{name}] sharded advance {step}: launches {k['mesh']}")
        for gi, ((alg, _), _) in enumerate(batch.groups().items()):
            a, b = res[None][gi], res["mesh"][gi]
            if alg == "pagerank":
                for qi in range(a.shape[0]):
                    check_pagerank(np, f"[{name}] sharded advance {step} pagerank row {qi}",
                                   to_numpy(b[qi]), to_numpy(a[qi]).astype(np.float64),
                                   failures)
            elif not _bit_equal(torch, a, b):
                raise AssertionError(f"[{name}] sharded advance {step}: {alg} rows differ "
                                     f"from the unsharded chain")
        if step:
            sharded_ms.append(ms["mesh"])
        log(f"[{name}] sharded serving {st['mesh'].last_advance} {step} (mesh {n_d}): "
            f"{ms['mesh']:.3f} ms against unsharded {ms[None]:.3f} ms, "
            f"{st['mesh'].n_solved_unique} unique rows solved, K1 "
            f"{k['mesh']['segment_min_tiles']} / K3 {k['mesh']['segment_spmm_tiles']} "
            f"launches; rows equal to the unsharded chain")
        records.append(dict(graph=name, algorithm="serve_batch_sharded", step=step,
                            mesh=n_d, advance=st["mesh"].last_advance, ms=ms["mesh"],
                            unsharded_ms=ms[None],
                            k1_launches=k["mesh"]["segment_min_tiles"],
                            k3_launches=k["mesh"]["segment_spmm_tiles"]))
    carry = [st["mesh"]]

    def one_more():
        carry[0] = serve_batch(g, batch_at(base + (SERVE_ADVANCES + 1) * stride), tger,
                               state=carry[0], access="scan", backend="pallas_tiled",
                               mesh=mesh)[1]

    prof = profile_query(torch, f"[{name}] sharded serving advance (mesh {n_d})",
                         one_more, warm=False)
    nccl = {kn: us for kn, us in prof["by_kernel"].items() if "nccl" in kn.lower()}
    nccl_us = sum(nccl.values())
    log(f"[{name}] sharded advance NCCL kernels: {nccl_us:.1f} us of "
        f"{prof['busy_us']:.1f} us device busy in "
        f"{sum(prof['count_by_kernel'][kn] for kn in nccl)} launches")
    rec = idle_record(np, name, "serve_batch_sharded_profile", prof, sharded_ms)
    rec.update(nccl_us=nccl_us, mesh=n_d)
    records.append(rec)
    return records


def dist_launcher(torch, seed, device="cuda"):
    """``launch/serve.py --graph --daemon --shard-queries 1`` under torchrun
    (one rank, NCCL) as a subprocess for a few ticks: it must exit 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.serve", "--graph",
           "--daemon", "--shard-queries", "1", "--ticks", str(DIST_DAEMON_TICKS),
           "--seed", str(seed)] + (["--device", device] if device != "cuda" else [])
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env,
                         cwd=str(ROOT))
    s = time.perf_counter() - t0
    for line in run.stdout.strip().splitlines():
        log(f"[torchrun] {line}")
    if run.returncode != 0:
        raise AssertionError(f"torchrun launcher exited {run.returncode}:\n"
                             f"{run.stderr[-3000:]}")
    log(f"[torchrun] --daemon --shard-queries 1: exit 0 in {s:.2f} s")
    return [dict(graph="power_law_small", algorithm="torchrun_daemon_shard_queries_1",
                 wall_s=s, ticks=DIST_DAEMON_TICKS)]


def dist_rank(rank, world, port, seed, device, out_dir):
    """One rank of the multi-card run: NCCL over ``world`` cards, the
    engine's EA on power_law (scan, edges over ``world`` ranks) equal to
    ``earliest_arrival``, and ``serving_path``'s batch at ``mesh=world``
    equal to the unsharded chain; writes its summary to a JSON file."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.generators import power_law_temporal_graph
    from repro_torch.distributed import init_process_group, make_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    init_process_group(device, init_method=f"tcp://localhost:{port}",
                       world_size=world, rank=rank)
    dev = torch.device(device, rank) if device == "cuda" else torch.device(device)
    g = power_law_temporal_graph(WIKI_TALK_VERTICES, WIKI_TALK_EDGES, seed=seed, device=dev)
    tger, fields, windows, sources = graph_context(torch, np, "power_law", g)
    mesh = make_mesh((world, 1), ("data", "model"), device=device)
    recs = dist_engine(torch, np, "power_law", g, tger, fields,
                       {"narrow": windows["narrow"], "wide": windows["narrow"]},
                       sources, mesh)
    failures = []
    from repro_torch.distributed import query_mesh

    recs += dist_serving(torch, np, "power_law", g, tger, fields, failures,
                         query_mesh(world, device=device))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(
        json.dumps(dict(records=recs, failures=failures)))


def distributed_path(torch, np, graphs, contexts, failures, seed, device="cuda"):
    """Distributed serving and the edge-partitioned engine on NCCL: a
    process group of one rank in this process (the engine on both graphs,
    sharded serving on power_law, the torchrun launcher), then, where the
    machine has more cards, min(cards, DIST_MAX_RANKS) spawned ranks.
    (``device="cpu"`` rehearses it on gloo.)"""
    import torch.distributed as dist

    from repro_torch.distributed import init_process_group, make_mesh, query_mesh

    init_process_group(device, init_method=f"tcp://localhost:{free_port()}",
                       world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        records = []
        for name, g in graphs.items():
            tger, fields, windows, sources = contexts[name]
            records += dist_engine(torch, np, name, g, tger, fields, windows, sources,
                                   mesh)
        tger, fields, _, _ = contexts["power_law"]
        records += dist_serving(torch, np, "power_law", graphs["power_law"], tger,
                                fields, failures, query_mesh(1, device=device))
    finally:
        dist.destroy_process_group()
    records += dist_launcher(torch, seed, device)
    world = min(torch.cuda.device_count(), DIST_MAX_RANKS) if device == "cuda" else 1
    if world > 1:
        import tempfile

        import torch.multiprocessing as mp

        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
            mp.start_processes(dist_rank, args=(world, free_port(), seed, "cuda", out_dir),
                               nprocs=world, join=True, start_method="spawn")
            for r in range(world):
                got = json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                failures += [f"rank {r}: {f}" for f in got["failures"]]
                if r == 0:
                    records += [dict(rec, world=world) for rec in got["records"]]
        log(f"distributed phase on {world} cards: every rank's checks held")
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
        h, k, v, _ = tf.layer_forward(cfg, blk, h, rot)
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
        h, k, v, _ = layer_forward(cfg, blk, model.embed[toks].to(cfg.dtype), rot)
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
    from repro_torch.tree import tree_map

    cfg, dev = model.cfg, model.device
    t0 = time.perf_counter()
    served = [r for r in reqs if r.generated]
    # 1. the first token, from prefill, against forward over the prompt
    first_gap, exact = 0.0, 0
    for r in served:
        row = forward(model, torch.as_tensor(r.prompt, device=dev)[None])[0][0, -1]
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
    wide = LM(wide_cfg, tree_map(lambda p: p.float(), model.params))
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
        # MoE blocks too: routing breaks exact ties by expert id (a stable
        # sort) in forward and in a decode step alike
        worst = float(errs.max()) if name == "float32" else max(kv_max, h_med, plain_max)
        if worst > LM_LAYER_TOL[name]:
            raise AssertionError(f"[lm] decode blocks off forward's in {name}: "
                                 f"{worst:.3g} > {LM_LAYER_TOL[name]:.3g}")
    del wide

    # 3. end to end, reported: each token against forward over prompt + prefix
    gaps, exact = [], 0
    for r in served:
        seq = np.concatenate([r.prompt, np.asarray(r.generated[:-1], np.int32)])
        rows = forward(model, torch.as_tensor(_padded(np, seq, cfg.q_chunk), device=dev))[0][
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
        if blk.index == 0:
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


def params_gap(got, want, lr):
    """Two parameter trees: (the largest entry gap over ``lr``, the share of
    entries more than 1e-5 of their leaf's largest value apart)."""
    from repro_torch.tree import tree_items

    worst, off, total = 0.0, 0, 0
    for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        d = (a - b).abs()
        worst = max(worst, float(d.max()) / lr)
        off += int((d > 1e-5 * b.abs().max()).sum())
        total += d.numel()
    return worst, off / total


def grads_gap(got, want):
    """Relative L2 error of a tree against another: over the whole tree, and
    the largest leaf's (name, error)."""
    from repro_torch.tree import tree_items

    num = den = 0.0
    worst = ("", 0.0)
    for (key, a), (_, b) in zip(tree_items(got), tree_items(want)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        d2, b2 = float((a - b).square().sum()), float(b.square().sum())
        num, den = num + d2, den + b2
        worst = max(worst, (key, (d2 / max(b2, 1e-300)) ** 0.5), key=lambda w: w[1])
    return (num / den) ** 0.5, worst


def train_compare(torch, np, seed, device="cuda"):
    """One train step at smollm-135m's widths (TRAIN_CMP_LAYERS layers) from
    the same weights and batch: float32 on the card (one batch, and 2
    microbatches) and on the CPU, and float64 on the CPU as the reference,
    TF32 off; held to TRAIN_TOL.  Returns the figures."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).cfg, n_layers=TRAIN_CMP_LAYERS,
                              dtype=torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 5)
    base = tf.init_lm(cfg, gen, device)
    host = next(MarkovCorpus(cfg.vocab, seed=seed).batches(TRAIN_CMP_BATCH, TRAIN_CMP_SEQ,
                                                           seed=seed + 1))

    def one_step(device, microbatches, dtype=torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = tf.LM(c, tree_map(lambda p: p.detach().to(device, dtype).clone(), base.params))
        opt = make_optimizer("adamw", TRAIN_CMP_LR)
        tcfg = TrainConfig(microbatches=microbatches)
        step = make_train_step(lambda p, b: tf.loss_fn(model, b), opt, tcfg)
        state = init_train_state(model.params, opt, tcfg)
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        t0 = time.perf_counter()
        params, state, m = step(model.params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        return dict(loss=loss, grad_norm=gnorm, s=time.perf_counter() - t0, params=params,
                    m=state["opt"]["m"])

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        card, micro = one_step(device, 1), one_step(device, 2)
        cpu, ref = one_step("cpu", 1), one_step("cpu", 1, torch.float64)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    cpu_err, cpu_leaf = grads_gap(cpu["m"], ref["m"])
    rec, bad = dict(card_step_s=card["s"], cpu_step_s=cpu["s"], cpu_grads_rel_l2=cpu_err,
                    cpu_grads_worst_leaf=cpu_leaf), []
    for label, got in (("card", card), ("card_microbatches_2", micro)):
        err, leaf = grads_gap(got["m"], ref["m"])
        gap, share = params_gap(got["params"], cpu["params"], TRAIN_CMP_LR)
        fig = dict(loss_rel=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                   grad_norm_rel=abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                   grads_rel_l2_over_cpu=err / cpu_err, grads_rel_l2=err,
                   grads_worst_leaf=leaf, params_gap_lr=gap, params_off_share=share)
        log(f"[train] one step, {cfg.n_layers} layers at {TRAIN_ARCH}'s widths, batch "
            f"{TRAIN_CMP_BATCH} x {TRAIN_CMP_SEQ}: {label} float32 against the CPU's float64 "
            f"(loss {got['loss']:.7f} / {ref['loss']:.7f}, grad norm {got['grad_norm']:.6f} / "
            f"{ref['grad_norm']:.6f}; the CPU's float32 gradients {cpu_err:.3g} off, worst "
            f"leaf {cpu_leaf}), parameters against the CPU's float32 step: {fig} "
            f"(tolerances {TRAIN_TOL}); {got['s']:.3f} s")
        bad += [(label, k) for k, tol in TRAIN_TOL.items() if not fig[k] <= tol]
        rec[label] = fig
    if bad:
        raise AssertionError(f"[train] steps off the reference: {bad} {rec}")
    return rec


def train_path(torch, np, seed, device="cuda"):
    """LM training through ``launch/train.py`` at TRAIN_ARCH's published
    config: TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ with a checkpoint
    every TRAIN_CKPT_EVERY, then a fresh run resumed from step
    TRAIN_CKPT_EVERY, both under ``torch.use_deterministic_algorithms`` (the
    resumed losses must equal the uninterrupted ones); losses finite and
    falling; ``--compression int8`` / ``topk`` and ``--microbatches 2`` runs
    of TRAIN_SHORT_STEPS; ``train_compare``; then TRAIN_TIMED_STEPS steps
    timed (ms per step, tokens/s, peak memory) and one profiled (idle share
    against the median step)."""
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import make_optimizer, warmup_cosine
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step

    out = ROOT / "build" / "train_ckpt"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--scale", "full", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--log-every", "10",
            "--seed", str(seed), "--device", device]
    ckpt = f"step_{TRAIN_CKPT_EVERY:010d}"
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        full = train.main(argv + ["--steps", str(TRAIN_STEPS), "--ckpt", str(out / "a"),
                                  "--ckpt-every", str(TRAIN_CKPT_EVERY)])
        full_s = time.perf_counter() - t0
        (out / "b").mkdir(parents=True)
        shutil.copytree(out / "a" / ckpt, out / "b" / ckpt)
        resumed = train.main(argv + ["--steps", str(TRAIN_STEPS), "--ckpt", str(out / "b"),
                                     "--ckpt-every", str(TRAIN_CKPT_EVERY), "--resume"])
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(out, ignore_errors=True)
    first, last = float(np.mean(full[:5])), float(np.mean(full[-5:]))
    log(f"[train] {TRAIN_ARCH}, {TRAIN_STEPS} steps in {full_s:.2f} s (deterministic "
        f"algorithms, checkpoints included): loss {full[0]:.4f} -> {full[-1]:.4f} (mean of "
        f"the first 5 {first:.4f}, of the last 5 {last:.4f}); resumed from step "
        f"{TRAIN_CKPT_EVERY}: {len(resumed)} losses, equal to the uninterrupted run's: "
        f"{resumed == full[TRAIN_CKPT_EVERY:]}")
    if not np.isfinite(full).all() or not last < first:
        raise AssertionError(f"[train] losses not finite and falling: {full}")
    if resumed != full[TRAIN_CKPT_EVERY:]:
        raise AssertionError(f"[train] resumed losses {resumed} != {full[TRAIN_CKPT_EVERY:]}")
    short = {}
    for flags in (["--compression", "int8"], ["--compression", "topk"],
                  ["--microbatches", "2"]):
        losses = train.main(argv + ["--steps", str(TRAIN_SHORT_STEPS)] + flags)
        if not np.isfinite(losses).all():
            raise AssertionError(f"[train] {flags}: losses {losses}")
        short[" ".join(flags)] = losses
    log(f"[train] short runs of {TRAIN_SHORT_STEPS} steps: {short}")
    figures = train_compare(torch, np, seed, device)

    # ms per step, tokens/s and a profile, outside deterministic mode
    cfg = get_arch(TRAIN_ARCH).cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = tf.init_lm(cfg, gen, device)
    opt = make_optimizer("adamw", warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10 + 1, TRAIN_STEPS))
    step = make_train_step(lambda p, b: tf.loss_fn(model, b), opt, TrainConfig())
    state = init_train_state(model.params, opt, TrainConfig())
    batches = MarkovCorpus(cfg.vocab, seed=seed).batches(TRAIN_BATCH, TRAIN_SEQ, seed=seed + 1)
    box = {"state": state}

    def run():
        batch = {k: torch.as_tensor(v, device=device) for k, v in next(batches).items()}
        _, box["state"], m = step(model.params, box["state"], batch)
        return float(m["loss"])

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        run()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_query(torch, f"[train] one {TRAIN_ARCH} step", run, top=10, warm=False)
    med = float(np.median(ms))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6.0 * cfg.n_active_params * tokens
    rec = dict(graph="lm", algorithm="train", arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=TRAIN_STEPS, losses_first_last=[full[0], full[-1]],
               resumed_equal=True, step_ms=[round(t, 3) for t in ms],
               step_ms_median=med, step_ms_mean=float(np.mean(ms)),
               tokens_per_s=tokens / (med / 1e3), model_flops_per_step=flops,
               model_tflops_per_s=flops / (med / 1e3) / 1e12, peak_memory_bytes=peak,
               profile_wall_us=prof["wall_us"], profile_busy_us=prof["busy_us"],
               idle_share=1 - prof["busy_us"] / (med * 1e3),
               profile_launches=sum(prof["count_by_kernel"].values()), **figures)
    log(f"[train] {cfg.name} step at batch {TRAIN_BATCH} x {TRAIN_SEQ}: median "
        f"{med:.3f} ms (mean {rec['step_ms_mean']:.3f}), {rec['tokens_per_s']:.1f} tokens/s, "
        f"{rec['model_tflops_per_s']:.2f} model TFLOP/s (6 N D), peak memory "
        f"{peak / 2**30:.2f} GiB; the profiled step {prof['busy_us']:.1f} us busy: idle share "
        f"{rec['idle_share']:.3f} against the median step")
    return [rec]


def k4_at(torch, k4, cfg, gen, lengths_hi):
    """K4 in bfloat16 at a model's decode shape (LM_SLOTS rows, LM_MAX_SEQ
    positions, ragged lengths up to ``lengths_hi``) against its plain version
    on float32 copies, timed beside it, beside scaled_dot_product_attention
    and beside its bound."""
    import torch.nn.functional as F

    B, S, KH, Dh, H = LM_SLOTS, LM_MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    dev = gen.device
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((B, H, Dh), (B, S, KH, Dh), (B, S, KH, Dh)))
    lens = torch.randint(1, lengths_hi + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    want = k4.decode_attention_plain(q.float(), k.float(), v.float(), lens).to(q.dtype)
    err = close_err(torch, k4.decode_attention(q, k, v, lens), want, **K4_TOL["bfloat16"])
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], ks, vs, attn_mask=mask,
                                              enable_gqa=True)

    close_err(torch, sdpa()[:, :, 0], want, **LIBRARY_TOL["bfloat16"])
    n_valid = int(lens.sum())
    b_ms, b_by = bound_ms(2 * n_valid * KH * Dh * 2 + 2 * B * H * Dh * 2 + 4 * B,
                          4 * n_valid * H * Dh)
    return dict(shape=dict(B=B, S=S, KH=KH, G=H // KH, Dh=Dh, valid_positions=n_valid),
                max_abs_err=err, ms=cuda_ms(torch, lambda: k4.decode_attention(q, k, v, lens)),
                plain_ms=cuda_ms(torch, lambda: k4.decode_attention_plain(q, k, v, lens)),
                library_ms=cuda_ms(torch, sdpa), bound_ms=b_ms, bound_by=b_by)


def moe_path(torch, np, seed, k4, device="cuda"):
    """MoE at MOE_ARCH's published widths: ``moe_ffn`` against a per-token
    dense mixture (float32, TF32 off, MOE_FFN_TOKENS tokens, ample capacity)
    and in bfloat16 against the all-experts mix; K4 at the MoE decode shape;
    ``lm_path`` on MOE_SERVE_LAYERS layers at the ample capacity factor
    MOE_AMPLE (nothing dropped, so the served tokens compare with
    ``forward``); MOE_TRAIN_STEPS train steps on MOE_TRAIN_LAYERS layers at
    the published capacity factor.  Returns (records, K4 record, the serving
    run's launch counts)."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import make_optimizer, warmup_cosine
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_map

    full = get_arch(MOE_ARCH).cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    mcfg = dataclasses.replace(full.moe, capacity_factor=MOE_AMPLE)
    K = mcfg.top_k
    params, _ = moe_mod.init_moe(gen, full.d_model, mcfg)
    x = torch.randn((MOE_FFN_TOKENS, full.d_model), generator=gen, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            got, aux = moe_mod.moe_ffn(params, x, mcfg)
            probs = torch.softmax(x @ params["router"], -1)
            top_w, top_ids = torch.topk(probs, K)
            top_w = top_w / top_w.sum(-1, keepdim=True)
            ids = top_ids.cpu().tolist()
            ref = torch.zeros_like(x)
            for t in range(MOE_FFN_TOKENS):
                for j, e in enumerate(ids[t]):
                    h = F.silu(x[t] @ params["w_gate"][e]) * (x[t] @ params["w_up"][e])
                    ref[t] += top_w[t, j] * (h @ params["w_down"][e])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    ffn_err = close_err(torch, got, ref, **MOE_FFN_TOL)
    with torch.no_grad():
        p16 = tree_map(lambda p: p.to(torch.bfloat16), params)
        sort16, _ = moe_mod.moe_ffn(p16, x.to(torch.bfloat16), mcfg)
        mix16, _ = moe_mod.moe_ffn(p16, x.to(torch.bfloat16),
                                   dataclasses.replace(mcfg, dense_mix=True))
    bf16_rel = float((sort16.double() - mix16.double()).norm() / mix16.double().norm())
    log(f"[moe] moe_ffn at {MOE_ARCH}'s widths (d_model {full.d_model}, {mcfg.n_experts} "
        f"experts, top-{K}, expert d_ff {mcfg.d_ff}), {MOE_FFN_TOKENS} tokens: float32 "
        f"against the per-token dense mixture within {MOE_FFN_TOL} (max abs err {ffn_err:.3g}, "
        f"aux {float(aux):.4f}); bfloat16 sort dispatch against the all-experts mix: relative "
        f"L2 {bf16_rel:.3g} (reported)")
    del params, x, got, ref, p16, sort16, mix16

    k4_rec = k4_at(torch, k4, full, gen, LM_PROMPT_LEN[1] + LM_MAX_NEW)
    log(f"[moe] K4 at the MoE decode shape: {k4_rec}")

    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS, moe=mcfg)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    model = tf.init_lm(cfg, gen, device)
    torch.cuda.synchronize()
    log(f"[moe] serving {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, capacity factor "
        f"{MOE_AMPLE} (C >= T: nothing dropped), {cfg.dtype}; {cfg.n_params} parameters "
        f"({cfg.n_active_params} active a token); init in {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        records, counts = lm_path(torch, np, model, seed)
    del model

    tcfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    model = tf.init_lm(tcfg, gen, device)
    opt = make_optimizer("adamw", warmup_cosine(3e-3, MOE_TRAIN_STEPS // 10 + 1,
                                                MOE_TRAIN_STEPS))
    step = make_train_step(lambda p, b: tf.loss_fn(model, b), opt, TrainConfig())
    state = init_train_state(model.params, opt, TrainConfig())
    batches = MarkovCorpus(tcfg.vocab, seed=seed).batches(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                                                          seed=seed + 1)
    losses, ms, auxes = [], [], []
    for _ in range(MOE_TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device=device) for k, v in next(batches).items()}
        t0 = time.perf_counter()
        _, state, m = step(model.params, state, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        auxes.append(float(m["aux"]))
    del model, state
    log(f"[moe] training {tcfg.name}, {tcfg.n_layers} layers, capacity factor "
        f"{tcfg.moe.capacity_factor}, batch {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}: losses "
        f"{[round(l, 4) for l in losses]}, aux {[round(a, 4) for a in auxes]}, ms per step "
        f"{[round(t, 1) for t in ms]}")
    if not np.isfinite(losses).all() or not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"[moe] training losses not finite and falling: {losses}")
    records[0].update(phase="moe_serving", moe_ffn_max_abs_err=ffn_err,
                      moe_ffn_bf16_rel_l2=bf16_rel)
    records.append(dict(graph="lm", algorithm="train", arch=tcfg.name,
                        layers=tcfg.n_layers, batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
                        losses=losses, step_ms=ms,
                        step_ms_median=float(np.median(ms[1:])),
                        tokens_per_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (
                            float(np.median(ms[1:])) / 1e3)))
    return records, k4_rec, counts


# ---------------------------------------------------------------------------
# sharded training on a DTensor mesh (a one-rank NCCL group)
# ---------------------------------------------------------------------------

# smollm-135m at its published config (TRAIN_ARCH, TRAIN_BATCH x TRAIN_SEQ)
# trained through LMFamily.train_objects (AdamW at SHARD_LR) with DTensor
# parameters and state on a (1, 1) ("data", "model") mesh and unsharded,
# in turns from the same weights and batches (NCCL
# refuses two ranks on one card, so world size 1 is all one card allows):
# SHARD_STEPS steps each (ms a step: medians), held to TRAIN_TOL's loss,
# gradient-norm and parameter bounds; then a checkpoint, SHARD_CONT more
# steps, and the same steps from the checkpoint restored onto the (1, 1)
# mesh of a fresh process group (both under deterministic algorithms: the
# losses must be equal).  Then one step of MOE_ARCH at MOE_SERVE_LAYERS
# layers (the MoE dispatch under DTensor) against its unsharded step.
SHARD_STEPS, SHARD_CONT = 6, 3
SHARD_LR = 3e-4     # LMFamily.optimizer's default rate (smollm's AdamW)
# The bfloat16 MoE step: a router probability at the top-k boundary rounds
# either way, and a token sent to another expert moves the mean loss by
# ~1e-5 while the gradients barely move (an H100 80GB HBM3 at 700 W read a
# loss 1.19e-5 and a gradient norm 7.7e-8 apart), so its loss is held to
# 1e-4 and the rest to TRAIN_TOL
MOE_SHARD_TOL = dict(TRAIN_TOL, loss_rel=1e-4)


def device_params_gap(got, want, lr):
    """``params_gap`` leaf by leaf on the device (trees too large for the
    host's float64): (largest entry gap over ``lr``, share of entries more
    than 1e-5 of their leaf's largest value apart)."""
    from repro_torch.distributed.sharding import full_value
    from repro_torch.tree import tree_items

    worst, off, total = 0.0, 0, 0
    for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
        a, b = full_value(a.detach()).float(), full_value(b.detach()).float()
        d = (a - b).abs()
        worst = max(worst, float(d.max()) / lr)
        off += int((d > 1e-5 * b.abs().max()).sum())
        total += d.numel()
    return worst, off / total


def _trees_equal(torch, got, want) -> bool:
    from repro_torch.distributed.sharding import full_value
    from repro_torch.tree import tree_items

    return all(torch.equal(full_value(a.detach()), full_value(b.detach()))
               for (_, a), (_, b) in zip(tree_items(got), tree_items(want)))


def sharded_moe_step(torch, np, seed, mesh, device="cuda"):
    """One train step of MOE_ARCH at MOE_SERVE_LAYERS layers with DTensor
    parameters and state on ``mesh`` against its unsharded step (the MoE
    dispatch under DTensor).  Returns its record."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_map

    gen = torch.Generator(device=device)
    log(f"[sharded] before the MoE step: {torch.cuda.memory_allocated()} B allocated")
    # one MoE step at MOE_SERVE_LAYERS layers, the unsharded step first;
    # both draw the same weights from one seed, and the unsharded result
    # waits on the host.  The step takes SGD with momentum: AdamW's float32
    # update of the 3.1e9-parameter tree beside its moments (24.9 GB) ran
    # out of the card's 80 GB (the family's AdamW is the smollm run's)
    mfam = get_arch(MOE_ARCH)
    mcfg = mfam.mesh_cfg(dataclasses.replace(mfam.cfg, n_layers=MOE_SERVE_LAYERS), mesh)
    batch = {k: torch.as_tensor(v, device=device) for k, v in next(
        MarkovCorpus(mcfg.vocab, seed=seed).batches(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                                                    seed=seed + 1)).items()}
    moe = {}
    for label in ("unsharded", "sharded"):
        gen.manual_seed(seed + 8)
        model = tf.init_lm(mcfg, gen, device)
        if label == "sharded":
            model = mfam.shard(model, mesh)
        opt = make_optimizer("sgd", SHARD_LR)
        step = make_train_step(lambda p, b: tf.loss_fn(model, b), opt, TrainConfig())
        state = init_train_state(model.params, opt, TrainConfig())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if label == "sharded":
            from repro_torch.distributed.sharding import use_mesh

            with use_mesh(mesh, rules=mfam.rules_override):
                _, _, m = step(model.params, state, batch)
        else:
            _, _, m = step(model.params, state, batch)
        moe[label] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          ms=(time.perf_counter() - t0) * 1e3,
                          peak=torch.cuda.max_memory_allocated(), params=model.params)
        del state, step, opt, model, m
        if label == "unsharded":
            moe[label]["params"] = tree_map(lambda p: p.detach().cpu(),
                                            moe[label]["params"])
        torch.cuda.empty_cache()
    moe["unsharded"]["params"] = tree_map(lambda p: p.to(device),
                                          moe["unsharded"]["params"])
    mgap, mshare = device_params_gap(moe["sharded"]["params"],
                                     moe["unsharded"]["params"], SHARD_LR)
    mbit = _trees_equal(torch, moe["sharded"]["params"], moe["unsharded"]["params"])
    a, b = moe["sharded"], moe["unsharded"]
    mfig = dict(loss_rel=abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                grad_norm_rel=abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"],
                params_gap_lr=mgap, params_off_share=mshare)
    log(f"[sharded] {mcfg.name} at {mcfg.n_layers} layers ({mcfg.moe.n_experts} experts, "
        f"n_groups {mcfg.moe.n_groups}), batch {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}: one "
        f"step sharded loss {a['loss']:.6f} in {a['ms']:.1f} ms (peak {a['peak']} B), "
        f"unsharded {b['loss']:.6f} in {b['ms']:.1f} ms (peak {b['peak']} B); figures "
        f"{mfig} (tolerances {MOE_SHARD_TOL}); parameters bit-identical: {mbit}")
    bad = [k for k in ("loss_rel", "grad_norm_rel", "params_gap_lr")
           if not mfig[k] <= MOE_SHARD_TOL[k]]
    if bad:
        raise AssertionError(f"[sharded] MoE step off the unsharded one: {bad} {mfig}")
    del moe, a, b
    return dict(graph="lm", algorithm="sharded_train_step", arch=mcfg.name,
                layers=mcfg.n_layers, mesh=[1, 1], batch=MOE_TRAIN_BATCH,
                seq=MOE_TRAIN_SEQ, bitwise=mbit, **mfig)


def sharded_train_path(torch, np, seed, device="cuda"):
    """Sharded training on a one-rank NCCL group (see SHARD_STEPS): one
    qwen3-moe step at MOE_SERVE_LAYERS layers (``sharded_moe_step``), then
    smollm-135m sharded against unsharded and the checkpoint restored onto a
    fresh mesh.  Returns records."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.distributed import init_process_group, make_mesh
    from repro_torch.distributed.sharding import spec_tree_sharding
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import state_axes
    from repro_torch.train.train_step import TrainConfig, init_train_state
    from repro_torch.tree import tree_map

    def group():
        init_process_group(device, init_method=f"tcp://localhost:{free_port()}",
                           world_size=1, rank=0)
        return make_mesh((1, 1), ("data", "model"), device=device)

    fam = get_arch(TRAIN_ARCH)
    cfg = fam.cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 7)
    base = tf.init_lm(cfg, gen, device)
    clone = lambda: tree_map(lambda p: p.detach().clone(), base.params)  # noqa: E731

    def trainer(model, mesh):
        opt, step = fam.train_objects(model, mesh)
        return step, init_train_state(model.params, opt, TrainConfig())

    def batches(skip=0):
        it = MarkovCorpus(cfg.vocab, seed=seed).batches(TRAIN_BATCH, TRAIN_SEQ, seed=seed + 1)
        for _ in range(skip):
            next(it)
        return ({k: torch.as_tensor(v, device=device) for k, v in b.items()} for b in it)

    ckpt = ROOT / "build" / "sharded_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mesh = group()
    try:
        moe_rec = sharded_moe_step(torch, np, seed, mesh, device)
        torch.cuda.empty_cache()
        runs = {}
        for label in ("unsharded", "sharded"):
            model = tf.LM(cfg, clone())
            if label == "sharded":
                model = fam.shard(model, mesh)
            step, state = trainer(model, mesh if label == "sharded" else None)
            runs[label] = dict(model=model, step=step, state=state, batches=batches(),
                               loss=[], grad_norm=[], ms=[])
        wq = runs["sharded"]["model"].params["layers"]["wq"]
        placements = [str(p) for p in wq.placements]
        for i in range(SHARD_STEPS):  # in turns, the order alternating
            for label in (("unsharded", "sharded") if i % 2 == 0 else
                          ("sharded", "unsharded")):
                r = runs[label]
                batch = next(r["batches"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, r["state"], m = r["step"](r["model"].params, r["state"], batch)
                r["loss"].append(float(m["loss"]))
                r["grad_norm"].append(float(m["grad_norm"]))
                r["ms"].append((time.perf_counter() - t0) * 1e3)
        u, sh = runs["unsharded"], runs["sharded"]
        gap, share = device_params_gap(sh["model"].params, u["model"].params, SHARD_LR)
        bitwise = _trees_equal(torch, sh["model"].params, u["model"].params)
        fig = dict(loss_rel=max(abs(a - b) / abs(b) for a, b in zip(sh["loss"], u["loss"])),
                   grad_norm_rel=max(abs(a - b) / b for a, b in
                                     zip(sh["grad_norm"], u["grad_norm"])),
                   params_gap_lr=gap, params_off_share=share)
        peaks = {}
        for label, r in runs.items():  # one more step each, its peak alone
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, r["state"], m = r["step"](r["model"].params, r["state"], next(r["batches"]))
            float(m["loss"])
            peaks[label] = torch.cuda.max_memory_allocated()
        prof = profile_query(
            torch, f"[sharded] one {TRAIN_ARCH} step on a (1, 1) mesh",
            lambda: float(sh["step"](sh["model"].params, sh["state"],
                                     next(sh["batches"]))[2]["loss"]), top=10, warm=False)
        med = {k: float(np.median(r["ms"])) for k, r in runs.items()}
        sh_ms, un_ms = sh["ms"], u["ms"]
        log(f"[sharded] {cfg.name} at batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW at {SHARD_LR}, "
            f"{SHARD_STEPS} steps in turns: sharded (wq {placements}) losses {sh['loss']}, "
            f"unsharded {u['loss']}; figures {fig} (tolerances {TRAIN_TOL}); parameters "
            f"bit-identical: {bitwise}; ms a step sharded {[round(t, 3) for t in sh['ms']]} "
            f"(median {med['sharded']:.3f}), unsharded {[round(t, 3) for t in u['ms']]} "
            f"(median {med['unsharded']:.3f}); peak memory of a step sharded "
            f"{peaks['sharded']} B, unsharded {peaks['unsharded']} B; the profiled sharded "
            f"step {prof['busy_us']:.1f} us busy: idle share "
            f"{1 - prof['busy_us'] / (med['sharded'] * 1e3):.3f} against the median")
        bad = [k for k in ("loss_rel", "grad_norm_rel", "params_gap_lr")
               if not fig[k] <= TRAIN_TOL[k]]
        if bad:
            raise AssertionError(f"[sharded] sharded steps off the unsharded ones: {bad} {fig}")
        del runs["unsharded"], u
        # checkpoint, then the uninterrupted continuation (deterministic)
        done = SHARD_STEPS + 2  # the peak step and the profiled step
        torch.use_deterministic_algorithms(True)
        try:
            CheckpointManager(str(ckpt)).save(done, {"params": sh["model"].params,
                                                     "state": sh["state"]})
            cont = []
            for _ in range(SHARD_CONT):
                _, sh["state"], m = sh["step"](sh["model"].params, sh["state"],
                                               next(sh["batches"]))
                cont.append(float(m["loss"]))
        finally:
            torch.use_deterministic_algorithms(False)
        del runs, sh
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # the survivors' fresh group: restore onto its mesh and go on
    mesh = group()
    try:
        axes, shapes = tf.param_axes(cfg), tf.param_shapes(cfg)
        template = tf.LM(cfg, clone())
        _, tmpl_state = trainer(template, None)
        shardings = {"params": spec_tree_sharding(axes, shapes, mesh),
                     "state": {"opt": spec_tree_sharding(state_axes(fam.optimizer_kind, axes,
                                                                    shapes),
                                                         {"m": shapes, "v": shapes}, mesh),
                               "step": None}}
        torch.use_deterministic_algorithms(True)
        try:
            restored, step0 = CheckpointManager(str(ckpt)).restore(
                {"params": template.params, "state": tmpl_state}, shardings=shardings)
            del template, tmpl_state
            model = tf.LM(cfg, restored["params"])
            step, _ = trainer(model, mesh)
            state, it, resumed = restored["state"], batches(skip=step0), []
            for _ in range(SHARD_CONT):
                _, state, m = step(model.params, state, next(it))
                resumed.append(float(m["loss"]))
        finally:
            torch.use_deterministic_algorithms(False)
        del model, state, restored
        log(f"[sharded] checkpoint at step {step0}, restored onto a fresh (1, 1) mesh with "
            f"shardings=: the next {SHARD_CONT} losses {resumed}, the uninterrupted run's "
            f"{cont}: equal {resumed == cont}")
        if resumed != cont:
            raise AssertionError(f"[sharded] resumed losses {resumed} != {cont}")
        shutil.rmtree(ckpt, ignore_errors=True)
        del base
        torch.cuda.empty_cache()

    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return [dict(graph="lm", algorithm="sharded_train", arch=cfg.name, mesh=[1, 1],
                 world=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=SHARD_STEPS,
                 wq_placements=placements, bitwise=bitwise,
                 step_ms_sharded=sh_ms, step_ms_unsharded=un_ms,
                 step_ms_median_sharded=med["sharded"],
                 step_ms_median_unsharded=med["unsharded"],
                 peak_memory_bytes_sharded=peaks["sharded"],
                 peak_memory_bytes_unsharded=peaks["unsharded"],
                 profile_wall_us=prof["wall_us"], profile_busy_us=prof["busy_us"],
                 idle_share=1 - prof["busy_us"] / (med["sharded"] * 1e3),
                 profile_launches=sum(prof["count_by_kernel"].values()),
                 resumed_equal=True, **fig),
            moe_rec]


# ---------------------------------------------------------------------------
# the examples (examples/*_torch.py) on the card against the CPU
# ---------------------------------------------------------------------------

EXAMPLE_TRAIN_CMP_STEPS = 5      # card against CPU from the same weights
EXAMPLE_PR_TOL = dict(rtol=1e-5, atol=1e-7)   # test_torch_pagerank.py's
EXAMPLE_BC_REL = 1e-5                         # test_torch_betweenness.py's


def _example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _example_cli(argv, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable] + argv, capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=str(ROOT))
    if run.returncode != 0:
        raise AssertionError(f"{' '.join(argv)} exited {run.returncode}:\n{run.stderr[-3000:]}")
    return run.stdout.strip().splitlines(), time.perf_counter() - t0


def examples_path(torch, np, seed, device="cuda"):
    """Each ``examples/*_torch.py`` on the card, held to its ``--device cpu``
    run on this machine (every CPU run takes well under a minute here):
    integers equal, floats within the reference's tolerances.  The
    distributed example runs under ``torchrun`` (one NCCL rank) against 8
    spawned gloo ranks; the trainer runs its default 200 steps on the card
    (loss falling) and EXAMPLE_TRAIN_CMP_STEPS steps from the same
    CPU-drawn weights on both (TF32 off, losses within rtol 1e-5); serving
    must launch K4.  Returns (records, launch counts of the card runs)."""
    from unittest import mock

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import tree_map

    rec, bad = dict(graph="examples", algorithm="examples"), []
    reset_launch_counts()

    q = _example("quickstart_torch")
    (card, rec["quickstart_card_s"]), (cpu, rec["quickstart_cpu_s"]) = \
        _timed(lambda: q.run(device)), _timed(lambda: q.run("cpu"))
    for k in ("n_vertices", "n_edges", "n_indexed", "method", "budget", "selectivity"):
        if card[k] != cpu[k]:
            bad.append(f"quickstart {k}: {card[k]} != {cpu[k]}")
    for k in ("arrival", "components"):
        if not np.array_equal(card[k], cpu[k]):
            bad.append(f"quickstart {k}: {card[k]} != {cpu[k]}")
    if not np.allclose(card["pagerank"], cpu["pagerank"], **EXAMPLE_PR_TOL):
        bad.append(f"quickstart pagerank: {card['pagerank']} vs {cpu['pagerank']}")

    c = _example("contact_tracing_torch")
    (card, rec["contact_tracing_card_s"]), (cpu, rec["contact_tracing_cpu_s"]) = \
        _timed(lambda: c.run(device=device)), _timed(lambda: c.run(device="cpu"))
    for k in ("n_indexed", "patient_zero", "windows"):
        if card[k] != cpu[k]:
            bad.append(f"contact_tracing {k}: {card[k]} != {cpu[k]}")
    if [v for v, _ in card["top"]] != [v for v, _ in cpu["top"]] or not all(
            abs(a - b) <= EXAMPLE_BC_REL * abs(b) for (_, a), (_, b) in
            zip(card["top"], cpu["top"])):
        bad.append(f"contact_tracing top: {card['top']} vs {cpu['top']}")
    rec["contact_tracing"] = card["windows"]

    script = "examples/distributed_analytics_torch.py"
    (card, rec["distributed_card_s"]) = _example_cli(
        ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1", script]
        + (["--device", device] if device != "cuda" else []))
    (cpu, rec["distributed_cpu_s"]) = _example_cli([script, "--device", "cpu"])
    for line in card:
        log(f"[examples] torchrun {line}")
    if card[1:] != cpu[1:] or card[1:3] != ["scan path == single-device: True",
                                           "selective path == single-device: True"]:
        bad.append(f"distributed_analytics: {card} vs {cpu}")
    rec["distributed"] = card

    s = _example("serve_lm_torch")
    (card, rec["serve_lm_card_s"]), (cpu, rec["serve_lm_cpu_s"]) = \
        _timed(lambda: s.run(device=device)), _timed(lambda: s.run(device="cpu"))
    counts = dict(launch_counts())
    fields = ("requests_completed", "tokens_generated", "steps")
    if [getattr(card, f) for f in fields] != [getattr(cpu, f) for f in fields]:
        bad.append(f"serve_lm: {card} vs {cpu}")
    if counts["decode_attention"] <= 0:
        bad.append(f"serve_lm launched no K4: {counts}")
    rec["serve_lm"] = {f: getattr(card, f) for f in fields}

    t = _example("train_lm_torch")
    ckpt = ROOT / "build" / "example_ckpt"
    losses, rec["train_lm_card_s"] = _timed(lambda: t.run(device=device,
                                                          ckpt=str(ckpt / "card")))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        bad.append(f"train_lm: losses not finite and falling: {losses[0]} -> {losses[-1]}")
    rec["train_lm_first_last"] = [losses[0], losses[-1]]
    draw = train_mod.tf.init_lm

    def cpu_drawn(cfg, generator, device=None):
        m = draw(cfg, torch.Generator().manual_seed(seed), "cpu")
        return train_mod.tf.LM(cfg, tree_map(lambda p: p.detach().to(device), m.params))

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with mock.patch.object(train_mod.tf, "init_lm", cpu_drawn):
            pair = [t.run(steps=EXAMPLE_TRAIN_CMP_STEPS, device=d, ckpt=str(ckpt / d))
                    for d in (device, "cpu")]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(*pair))
    if not rel <= TRAIN_TOL["loss_rel"]:
        bad.append(f"train_lm: card losses {pair[0]} vs the CPU's {pair[1]}")
    rec["train_lm_loss_rel"] = rel
    log(f"[examples] {json.dumps(rec)}; K4 and the other kernels in the card runs: {counts}")
    if bad:
        raise AssertionError("[examples] " + "; ".join(bad))
    return [rec], counts


# ---------------------------------------------------------------------------
# the paper's cells at |V| = 1e7, |E| = 1e9 (configs/kairos.py)
# ---------------------------------------------------------------------------

KAIROS_VERTICES = 10_000_000
KAIROS_EDGES = 1_000_000_000
# synthetic_temporal_graph draws start-time gaps ~ Poisson(2): at 1e9 edges
# its end times would reach 2.2e9, past int32; Poisson(1) keeps them < 1.1e9
KAIROS_POISSON_LAM = 1.0
KAIROS_CHUNK = 1 << 27          # elements a pass while generating and checking
# ea_scan_1b / ea_sparse_1b: S cut from 128 to 2 (the reference's round
# holds [S, E] candidate, id and mask arrays, 13 B an element: 26 GB at S 2)
KAIROS_SCAN_SOURCES = 2
KAIROS_MAX_ROUNDS = 100_000     # the EA loops stop at their fixpoint
KAIROS_CC_MAX_ROUNDS = 200
KAIROS_PR_ROUNDS = 10
KAIROS_SAMPLE = 128             # sampled destinations per draw (by in-degree, uniform)
KAIROS_PR_TOL = dict(rtol=1e-5, atol=1e-7)  # test_torch_distributed.py's


def _slices(n, per=None):
    per = per or KAIROS_CHUNK
    return [slice(lo, min(lo + per, n)) for lo in range(0, n, per)]


def kairos_edges(torch, n_v, n_e, seed, device):
    """The paper's synthetic graph drawn on the device from ``seed``, with
    ``synthetic_temporal_graph``'s distributions (not its numpy draws):
    endpoints of lognormal rank, start times the cumulative sum of Poisson
    gaps (rate KAIROS_POISSON_LAM) in a random order, durations uniform up
    to a tenth of the last start.  Returns int32 (src, dst, t_start, t_end)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
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
        rate = torch.full((sl.stop - sl.start,), KAIROS_POISSON_LAM, device=device)
        c = torch.poisson(rate, generator=gen).to(torch.int64).cumsum(0) + carry
        t[sl] = c.to(torch.int32)
        carry = int(c[-1])
    keys = torch.randint(0, 2**31 - 1, (n_e,), dtype=torch.int32, device=device,
                         generator=gen)
    perm = torch.sort(keys)[1]          # the reference's shuffle of the start times
    del keys
    ts = t[perm]
    del t, perm
    max_duration = max(int(ts.max()) // 10, 1)
    te = torch.empty_like(ts)
    for sl in chunks:
        te[sl] = ts[sl] + torch.randint(0, max_duration + 1, (sl.stop - sl.start,),
                                        dtype=torch.int32, device=device, generator=gen)
    return src, dst, ts, te


def marked_edges(torch, np, mark, key, edges, window):
    """Host numpy (src, dst, ts, te) of the window's edges whose ``key``
    endpoint (``edges[0]`` or ``edges[1]``) is marked, found on the card a
    chunk at a time."""
    src, dst, ts, te, valid = edges
    ta, tb = window
    found = []
    for sl in _slices(src.shape[0]):
        m = mark[key[sl].long()] & valid[sl] & (ts[sl] >= ta) & (te[sl] <= tb)
        found.append(m.nonzero()[:, 0] + sl.start)
    idx = torch.cat(found)
    return tuple(a[idx].cpu().numpy() for a in (src, dst, ts, te))


def sampled_vertices(torch, np, rng, edges, n_v):
    """KAIROS_SAMPLE destinations of seeded random edges (by in-degree) and
    KAIROS_SAMPLE uniform vertices, unique, on the host."""
    pos = torch.as_tensor(rng.integers(0, edges[0].shape[0], KAIROS_SAMPLE),
                          device=edges[1].device)
    by_degree = edges[1][pos].cpu().numpy()
    return np.unique(np.concatenate([by_degree, rng.integers(0, n_v, KAIROS_SAMPLE)]))


def window_ea_oracle(np, s, d, t1, t2, sources, ta):
    """Earliest arrival from each source over the given edges (all inside
    the window), in numpy: (rows, vertices, arrivals) of every reached
    vertex, in row-major order."""
    sources = np.asarray(sources)
    verts = np.unique(np.concatenate([s, d, sources]))
    si, di = np.searchsorted(verts, s), np.searchsorted(verts, d)
    S = len(sources)
    arr = np.full((S, len(verts)), INF, np.int64)
    arr[np.arange(S), np.searchsorted(verts, sources)] = ta
    rows = np.repeat(np.arange(S), len(s))
    while True:
        a = arr[:, si]
        cand = np.where((a <= t1) & (a < INF), t2, INF)
        new = arr.copy()
        np.minimum.at(new, (rows, np.tile(di, S)), cand.reshape(-1))
        if (new == arr).all():
            break
        arr = new
    r, c = np.nonzero(arr < INF)
    return r, verts[c], arr[r, c]


def reached(torch, out):
    """(rows, vertices, arrivals) of the finite entries of an [S, V] EA
    result, on the host, in row-major order."""
    nz = (out < INF).nonzero()
    vals = out[nz[:, 0], nz[:, 1]]
    return nz[:, 0].cpu().numpy(), nz[:, 1].cpu().numpy(), vals.cpu().numpy()


def ea_fixpoint_misses(torch, np, out, arr0, edges, window, verts):
    """At each sampled vertex v and source row r: out[r, v] must equal
    min(arr0[r, v], min te over v's window in-edges with out[r, src] <= ts
    and finite), the EA equation (a numpy oracle on the gathered edges).
    Returns the number of (row, vertex) pairs that miss."""
    mark = torch.zeros(out.shape[1], dtype=torch.bool, device=out.device)
    mark[torch.as_tensor(verts, device=out.device)] = True
    s, d, t1, t2 = marked_edges(torch, np, mark, edges[1], edges, window)
    a_src = out[:, torch.as_tensor(s, device=out.device).long()].cpu().numpy()
    vi = torch.as_tensor(verts, device=out.device).long()
    want = arr0[:, vi].cpu().numpy().astype(np.int64)
    col = np.searchsorted(verts, d)
    for r in range(out.shape[0]):
        cand = np.where((a_src[r] <= t1) & (a_src[r] < INF), t2, INF)
        np.minimum.at(want[r], col, cand)
    return int((want != out[:, vi].cpu().numpy()).sum())


def cc_new_labels(torch, np, labels, edges, window, verts):
    """min(labels[v], labels over v's window in- and out-neighbours) at each
    of ``verts`` (the CC round before its pointer jump), in numpy on the
    gathered edges."""
    dev = labels.device
    mark = torch.zeros(labels.shape[0], dtype=torch.bool, device=dev)
    mark[torch.as_tensor(verts, device=dev)] = True
    lab = labels.cpu().numpy() if labels.numel() < 1 << 20 else None
    out = labels[torch.as_tensor(verts, device=dev).long()].cpu().numpy().astype(np.int64)
    for key, other in ((1, 0), (0, 1)):
        e = marked_edges(torch, np, mark, edges[key], edges, window)
        nbr = (lab[e[other]] if lab is not None else
               labels[torch.as_tensor(e[other], device=dev).long()].cpu().numpy())
        np.minimum.at(out, np.searchsorted(verts, e[key]), nbr)
    return out


def cc_round_misses(torch, np, labels, new, edges, window, verts):
    """The CC round at the sampled vertices: new[v] = min(n1[v], n1[n1[v]])
    with n1 the hash-min of ``cc_new_labels`` (its second stage at the
    vertices the first points to).  Returns the number of misses."""
    n1 = cc_new_labels(torch, np, labels, edges, window, verts)
    w = np.unique(n1)
    n1_w = cc_new_labels(torch, np, labels, edges, window, w)
    want = np.minimum(n1, n1_w[np.searchsorted(w, n1)])
    got = new[torch.as_tensor(verts, device=new.device).long()].cpu().numpy()
    return int((want != got).sum())


def pr_round_err(torch, np, pr, new, inv, edges, window, verts, damping=0.85):
    """The PageRank round at the sampled vertices against a float64 numpy
    oracle on the gathered in-edges (float32 contributions, as the round):
    the largest error over tolerance (<= 1 holds KAIROS_PR_TOL)."""
    dev = pr.device
    n_v = pr.shape[0]
    mark = torch.zeros(n_v, dtype=torch.bool, device=dev)
    mark[torch.as_tensor(verts, device=dev)] = True
    s, d, _, _ = marked_edges(torch, np, mark, edges[1], edges, window)
    si = torch.as_tensor(s, device=dev).long()
    contrib = (pr[si].cpu().numpy() * inv[si].cpu().numpy()).astype(np.float64)
    agg = np.zeros(len(verts))
    np.add.at(agg, np.searchsorted(verts, d), contrib)
    want = (1.0 - damping) / n_v + damping * agg
    got = new[torch.as_tensor(verts, device=dev).long()].cpu().numpy().astype(np.float64)
    tol = KAIROS_PR_TOL["atol"] + KAIROS_PR_TOL["rtol"] * np.abs(want)
    return float((np.abs(got - want) / tol).max())


def kairos_profile(torch, device, label, fn) -> dict:
    """A profiled call's wall and busy microseconds and idle share (on the
    card only)."""
    if device != "cuda":
        return {}
    prof = profile_query(torch, label, fn, top=6)
    return dict(wall_us=prof["wall_us"], busy_us=prof["busy_us"],
                idle_share=1 - prof["busy_us"] / prof["wall_us"])


def kairos_path(torch, np, seed, device="cuda"):
    """The six KAIROS_CELLS on one card, through the distributed engine on
    a one-rank process group (NCCL; gloo with ``device="cpu"``): the graph
    drawn on the device (``kairos_edges``) and sorted per shard by time
    (``sort_edges_by_time_per_shard``); each cell held to an oracle
    independent of ``graph_engine``; then ``KairosFamily.smoke``.  Returns
    the records."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.kairos import KAIROS_CELLS, cell_plan
    from repro_torch.distributed import graph_engine as ge
    from repro_torch.distributed import init_process_group, make_mesh

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    n_v, n_e = KAIROS_VERTICES, KAIROS_EDGES
    rng = np.random.default_rng(seed + 11)
    records = []
    init_process_group(device, init_method=f"tcp://localhost:{free_port()}",
                       world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        t0 = time.perf_counter()
        raw = kairos_edges(torch, n_v, n_e, seed, device)
        sync()
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        edges = ge.sort_edges_by_time_per_shard(mesh, *raw)
        sync()
        t_sort = time.perf_counter() - t0
        del raw
        src, dst, ts, te, valid = edges
        t_lo, t_hi = int(ts[0]), int(te.max())
        log(f"[kairos] {n_v} vertices, {n_e} edges drawn on the card in {t_gen:.2f} s, "
            f"sorted by time in {t_sort:.2f} s; times {t_lo}..{t_hi}; "
            f"{4 * 4 * n_e + n_e} bytes of edge arrays")
        records.append(dict(graph="kairos_1b", cell="setup", generate_s=t_gen,
                            sort_s=t_sort, vertices=n_v, edges=n_e))

        def run_ea(cell, arr0, window, plan, sorted_edges=True):
            """The query twice: the first warms the allocator, the second
            is timed (and must equal the first)."""
            def once():
                return ge.run_distributed_ea(
                    mesh, arr0, edges[:4], valid, window, max_rounds=KAIROS_MAX_ROUNDS,
                    plan=plan, edges_time_sorted=sorted_edges, with_rounds=True)

            warm, _ = once()
            sync()
            t0 = time.perf_counter()
            out, rounds = once()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            if not torch.equal(out, warm):
                raise AssertionError(f"[kairos] {cell}: two runs of one query differ")
            return out, rounds, ms

        def ea_record(cell, S, window, rounds, ms, oracle, **kw):
            rec = dict(graph="kairos_1b", cell=cell, sources=S, window=list(window),
                       rounds=rounds, ms_per_query=ms, ms_per_round=ms / rounds,
                       oracle=oracle, **kw)
            log(f"[kairos] {cell}: {S} sources, window {window}, {rounds} rounds in "
                f"{ms:.1f} ms warm ({ms / rounds:.2f} ms a round); {oracle}")
            records.append(rec)

        def arrivals0(sources, ta):
            a = torch.full((len(sources), n_v), INF, dtype=torch.int32, device=device)
            a[torch.arange(len(sources), device=device),
              torch.as_tensor(sources, device=device)] = ta
            return a

        # -- ea_selective_1b: a window of at most budget_per_shard edges ------
        sel = KAIROS_CELLS["ea_selective_1b"]
        budget, S = sel.meta["budget_per_shard"], sel.meta["sources"]
        lo = int(rng.integers(n_e // 4, n_e // 2))
        ta = int(ts[lo])
        lo = int(torch.searchsorted(ts, torch.tensor([ta], dtype=ts.dtype, device=device)))
        tb = int(ts[min(lo + budget, n_e) - 1]) - 1
        hi = int(torch.searchsorted(ts, torch.tensor([tb], dtype=ts.dtype, device=device),
                                    right=True))
        narrow = (ta, tb)
        w_s, w_d, w_t1, w_t2 = (a[lo:hi].cpu().numpy() for a in (src, dst, ts, te))
        inside = w_t2 <= tb
        w_s, w_d, w_t1, w_t2 = w_s[inside], w_d[inside], w_t1[inside], w_t2[inside]
        starts = np.unique(w_s)
        sources = rng.choice(starts, min(S, len(starts)), replace=False)
        if len(sources) < S:
            rest = np.setdiff1d(rng.integers(0, n_v, 4 * S), sources)
            sources = np.concatenate([sources, rest[:S - len(sources)]])
        log(f"[kairos] narrow window {narrow}: {hi - lo} edges start in it (budget "
            f"{budget}), {int(inside.sum())} lie inside it")
        oracle = window_ea_oracle(np, w_s, w_d, w_t1, w_t2, sources, ta)
        arr0 = arrivals0(sources, ta)
        sel_out, rounds, ms = run_ea("ea_selective_1b", arr0, narrow, cell_plan(sel))
        got = reached(torch, sel_out)
        if not all(np.array_equal(g, w) for g, w in zip(got, oracle)):
            raise AssertionError("[kairos] ea_selective_1b differs from the numpy oracle")
        ea_record("ea_selective_1b", S, narrow, rounds, ms,
                  f"all {len(oracle[0])} reached (source, vertex) arrivals equal numpy's "
                  f"on the window's {len(w_s)} edges", budget=budget,
                  edges_in_window=hi - lo,
                  **kairos_profile(torch, device, "[kairos] ea_selective_1b query",
                                   lambda: ge.run_distributed_ea(
                                       mesh, arr0, edges[:4], valid, narrow,
                                       max_rounds=KAIROS_MAX_ROUNDS, plan=cell_plan(sel),
                                       edges_time_sorted=True)))
        sel_cell = KAIROS_CELLS["ea_selsparse_1b"]
        out, rounds, ms = run_ea("ea_selsparse_1b", arr0, narrow, cell_plan(sel_cell))
        if not torch.equal(out, sel_out):
            raise AssertionError("[kairos] ea_selsparse_1b differs from ea_selective_1b")
        ea_record("ea_selsparse_1b", S, narrow, rounds, ms,
                  "bit-identical to ea_selective_1b (the numpy oracle's)",
                  budget=budget, exchange_budget=sel_cell.meta["exchange_budget"])
        del out, arr0

        # -- ea_scan_1b / ea_sparse_1b: S cut to KAIROS_SCAN_SOURCES ------------
        Sc = KAIROS_SCAN_SOURCES
        scan_cell, sparse_cell = KAIROS_CELLS["ea_scan_1b"], KAIROS_CELLS["ea_sparse_1b"]
        arr0 = arrivals0(sources[:Sc], ta)
        out, rounds, ms = run_ea("ea_scan_1b", arr0, narrow, cell_plan(scan_cell),
                                 sorted_edges=False)
        if not torch.equal(out, sel_out[:Sc]):
            raise AssertionError("[kairos] ea_scan_1b on the narrow window differs from "
                                 "ea_selective_1b")
        ea_record("ea_scan_1b", Sc, narrow, rounds, ms,
                  "bit-identical to ea_selective_1b's rows (the numpy oracle's)",
                  cut=f"sources {Sc} of 128")
        del out, sel_out
        pos = rng.integers(0, n_e, 4 * Sc)
        wide = (int(np.quantile(ts[torch.as_tensor(pos, device=device)].cpu().numpy(),
                                0.25)), t_hi)
        wsrc = np.unique(src[torch.as_tensor(pos, device=device)].cpu().numpy())[:Sc]
        arr0 = arrivals0(wsrc, wide[0])
        verts = sampled_vertices(torch, np, rng, edges, n_v)
        results = {}
        for cell in (scan_cell, sparse_cell):
            out, rounds, ms = run_ea(cell.name, arr0, wide, cell_plan(cell),
                                     sorted_edges=False)
            results[cell.name] = out
            if cell is scan_cell:
                misses = ea_fixpoint_misses(torch, np, out, arr0, edges, wide, verts)
                if misses:
                    raise AssertionError(f"[kairos] ea_scan_1b wide: {misses} sampled "
                                         f"(source, vertex) pairs off the EA equation")
                oracle = (f"the EA equation holds at {len(verts)} sampled vertices x {Sc} "
                          f"sources (numpy on their in-edges); "
                          f"{int((out < INF).sum())} reached")
            else:
                if not torch.equal(out, results["ea_scan_1b"]):
                    raise AssertionError("[kairos] ea_sparse_1b differs from ea_scan_1b")
                oracle = "bit-identical to ea_scan_1b"
            ea_record(cell.name, Sc, wide, rounds, ms, oracle, cut=f"sources {Sc} of 128",
                      exchange_budget=cell.meta.get("exchange_budget", 0))
        del results, out, arr0

        # -- cc_1b and pagerank_1b: rounds over every edge ----------------------
        full = (t_lo, t_hi)
        cc_round = ge.make_cc_round(mesh, n_v)
        labels = torch.arange(n_v, dtype=torch.int32, device=device)
        ms = []
        for rnd in range(KAIROS_CC_MAX_ROUNDS):
            sync()
            t0 = time.perf_counter()
            new = cc_round(labels, *edges[:4], valid, full)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if rnd == 0:
                misses = cc_round_misses(torch, np, labels, new, edges, full, verts)
                if misses:
                    raise AssertionError(f"[kairos] cc_1b round 1: {misses} sampled "
                                         f"vertices off the numpy round")
            if torch.equal(new, labels):
                break
            labels = new
        else:
            raise AssertionError(f"[kairos] cc_1b: no fixpoint in {KAIROS_CC_MAX_ROUNDS} rounds")
        bad_edges = sum(int(((labels[src[sl].long()] != labels[dst[sl].long()])
                             & valid[sl]).sum()) for sl in _slices(n_e))
        ids = torch.arange(n_v, dtype=torch.int32, device=device)
        if bad_edges or bool((labels > ids).any()) or not torch.equal(
                labels[labels.long()], labels):
            raise AssertionError(f"[kairos] cc_1b labels: {bad_edges} edges join two "
                                 f"labels, or a label is not its class's root")
        n_comp = int((labels == ids).sum())
        prof = kairos_profile(torch, device, "[kairos] cc_1b round",
                              lambda: cc_round(labels, *edges[:4], valid, full))
        records.append(dict(graph="kairos_1b", cell="cc_1b", rounds=len(ms),
                            ms_per_round=float(np.median(ms)), ms_rounds=ms, **prof,
                            ms_per_query=float(np.sum(ms)), components=n_comp,
                            oracle="round 1 equals numpy at the sampled vertices; the "
                                   "fixpoint's labels agree along every edge, each label "
                                   "is its class's least id and a root"))
        log(f"[kairos] cc_1b: {len(ms)} rounds to the fixpoint, {np.median(ms):.1f} ms a "
            f"round (median), {np.sum(ms):.1f} ms in all; {n_comp} components; round 1 "
            f"equal to numpy at {len(verts)} sampled vertices, the labels agree on every "
            f"edge")
        del labels, new, ids
        deg = torch.zeros(n_v, dtype=torch.int64, device=device)
        for sl in _slices(n_e):
            deg += torch.bincount(src[sl].long(), minlength=n_v)
        inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1).float(),
                          torch.zeros((), device=device))
        del deg
        pr_round = ge.make_pagerank_round(mesh, n_v)
        pr = torch.full((n_v,), 1.0 / n_v, dtype=torch.float32, device=device)
        ms, worst = [], 0.0
        for rnd in range(KAIROS_PR_ROUNDS):
            sync()
            t0 = time.perf_counter()
            new = pr_round(pr, *edges[:4], valid, inv, full)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if rnd in (0, KAIROS_PR_ROUNDS - 1):
                worst = max(worst, pr_round_err(torch, np, pr, new, inv, edges, full, verts))
            pr = new
        if not worst <= 1.0:
            raise AssertionError(f"[kairos] pagerank_1b off the float64 oracle: "
                                 f"{worst:.3g} x tolerance")
        records.append(dict(graph="kairos_1b", cell="pagerank_1b", rounds=len(ms),
                            ms_per_round=float(np.median(ms)), ms_rounds=ms,
                            oracle_err_over_tol=worst,
                            oracle="rounds 1 and last against float64 numpy at the "
                                   "sampled vertices"))
        log(f"[kairos] pagerank_1b: {len(ms)} rounds, {np.median(ms):.1f} ms a round "
            f"(median); rounds 1 and {len(ms)} within {worst:.3g} of the float64 oracle's "
            f"tolerance at {len(verts)} sampled vertices")
        del pr, new, inv, edges, src, dst, ts, te, valid
        if device == "cuda":
            torch.cuda.empty_cache()
        smoke = get_arch("kairos").smoke(seed, device=device)
        log(f"[kairos] KairosFamily.smoke on the {device}: {smoke}")
        if not smoke["matches_single_device"]:
            raise AssertionError(f"[kairos] smoke: {smoke}")
    finally:
        dist.destroy_process_group()
    return records


# ---------------------------------------------------------------------------
# the GNN, NequIP and MIND models at their published widths
# ---------------------------------------------------------------------------

REDDIT_VERTICES = 232_965        # graphsage-reddit's minibatch_lg cell
REDDIT_EDGES = 114_615_892
GNN_SAGE_STEPS = 10
GNN_SMALL_STEPS = 20             # gcn-cora full_graph_sm, gin-tu molecule
GNN_STEP_TOL = dict(loss_rel=1e-5, grads_rel_l2=1e-4)   # one float32 step, card vs CPU
NEQUIP_STEPS = 10
# each molecule's atoms: a 4 x 4 x 2 grid of spacing 1.5 A, each atom
# jittered by up to 0.3 A, so no pair is under 0.9 A (a bond is 0.74 A or
# more); uniform draws in a box put some pairs at a tenth of an A, where the
# Bessel basis's 1/d drives energies and forces up by orders of magnitude
NEQUIP_SPACING = 1.5
NEQUIP_JITTER = 0.3
NEQUIP_E3_TOL = dict(energy=dict(rtol=1e-4, atol=1e-5),  # test_models.py's
                     forces=dict(rtol=1e-3, atol=1e-4))
MIND_SERVE_CALLS = 50
MIND_TRAIN_ITEMS = 10_000_000    # train_batch: the table cut from 1e8 rows
MIND_TRAIN_STEPS = 3
MIND_TOP_K = 100


def rel_l2(torch, got, want) -> float:
    num = sum(float(((g.double().cpu() - w.double().cpu()) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((w.double().cpu() ** 2).sum()) for w in want)
    return (num / max(den, 1e-300)) ** 0.5


def reddit_shaped(np, rng):
    """A graph of Reddit's shape (minibatch_lg): 232,965 vertices,
    114,615,892 edges with lognormal out-degrees (each at least 1), the
    edges listed by source, uniform destinations; 602 float32 features and
    41 classes."""
    n_v, n_e = REDDIT_VERTICES, REDDIT_EDGES
    w = rng.lognormal(0.0, 1.0, n_v)
    deg = np.floor(w / w.sum() * (n_e - n_v)).astype(np.int64) + 1
    deg[np.argsort(-w)[: n_e - int(deg.sum())]] += 1
    src = np.repeat(np.arange(n_v, dtype=np.int64), deg)
    dst = rng.integers(0, n_v, n_e)
    feats = rng.standard_normal((n_v, 602), dtype=np.float32)
    labels = rng.integers(0, 41, n_v)
    return src, dst, feats, labels


def gnn_step_profile(torch, np, label, step_fn):
    """One profiled step: the idle share and index_add's (and the gathers'
    backward) share of the device time."""
    prof = profile_query(torch, label, step_fn, top=10)
    busy = max(prof["busy_us"], 1e-9)
    share = lambda keys: sum(v for k, v in prof["by_kernel"].items()
                             if any(s in k for s in keys)) / busy
    return dict(wall_us=prof["wall_us"], busy_us=prof["busy_us"],
                idle_share=1 - prof["busy_us"] / prof["wall_us"],
                index_add_share=share(("indexFuncLargeIndex", "indexFuncSmallIndex",
                                       "index_add")),
                gather_backward_share=share(("indexing_backward", "index_put")),
                launches=sum(prof["count_by_kernel"].values()))


def gnn_paths(torch, np, seed, device):
    """graphsage-reddit at minibatch_lg (host sampling + AdamW steps, one
    step profiled; one float32 step on the card against the CPU), gcn-cora
    at full_graph_sm and gin-tu at molecule (AdamW steps)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.generators import molecule_batch_graph
    from repro_torch.data.samplers import NeighborSampler, batch_to_device
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.train.train_step import TrainConfig, init_train_state
    from repro_torch.tree import tree_leaves, tree_map

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed + 21)
    records = []
    fam = get_arch("graphsage-reddit")
    cell = fam.cells["minibatch_lg"].meta
    t0 = time.perf_counter()
    src, dst, feats, labels = reddit_shaped(np, rng)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler.from_edges(src, dst, len(feats), fanouts=cell["fanout"])
    t_csr = time.perf_counter() - t0
    del src, dst
    log(f"[gnn] Reddit-shaped graph: {len(feats)} vertices, {len(sampler.neighbors)} edges, "
        f"{feats.shape[1]} features ({feats.nbytes} bytes) drawn in {t_gen:.2f} s; the "
        f"sampler's CSR in {t_csr:.2f} s")
    cfg = fam.cfg_for("minibatch_lg")
    optimizer, step = fam.train_objects("minibatch_lg")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 22)
    params = gnn_mod.init_gnn(cfg, gen, device)
    n_pad, e_pad = cell["sub_nodes"], cell["sub_edges"]

    def sample():
        seeds = rng.choice(len(feats), cell["batch_nodes"], replace=False)
        return sampler.sample_padded(seeds, rng, n_pad, e_pad, feats, labels)

    # one float32 step from the initial weights on the card against the CPU
    # (TF32 off); a ReLU input within rounding of 0 can take the other side
    # on the other device, and the gradient then moves by that unit's share:
    # the flips of the first layer are counted
    def loss_and_grads(b):
        p = tree_map(lambda t: t.detach().to(b["x"].device).clone(), params)
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        lp, x = p["layers"][0], b["x"]
        with torch.no_grad():
            agg = gnn_mod.aggregate(x, b["src"], b["dst"], x.shape[0], cfg.aggregator)
            pre = x @ lp["w_self"] + agg @ lp["w_nbr"] + lp["b"]
        loss = gnn_mod.gnn_loss(p, b, cfg)
        return float(loss.detach()), torch.autograd.grad(loss, leaves), (pre > 0).cpu()

    first = sample()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = loss_and_grads(batch_to_device(first, device))
        cpu = loss_and_grads(batch_to_device(first, "cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    fig = dict(loss_rel=abs(card[0] - cpu[0]) / abs(cpu[0]),
               grads_rel_l2=rel_l2(torch, card[1], cpu[1]),
               relu_flips=int((card[2] != cpu[2]).sum()))
    log(f"[gnn] one float32 step of graphsage-reddit from its initial weights on the "
        f"{device} against the CPU: {fig} (tolerances {GNN_STEP_TOL})")
    if any(not fig[k] <= tol for k, tol in GNN_STEP_TOL.items()):
        raise AssertionError(f"[gnn] card step off the CPU's: {fig}")
    del card, cpu

    state = init_train_state(params, optimizer, TrainConfig())
    host_ms, dev_ms, losses = [], [], []
    for i in range(GNN_SAGE_STEPS):
        t0 = time.perf_counter()
        host = first if i == 0 else sample()
        t1 = time.perf_counter()
        batch = batch_to_device(host, device)
        _, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        sync()
        t2 = time.perf_counter()
        host_ms.append((t1 - t0) * 1e3)
        dev_ms.append((t2 - t1) * 1e3)
    if not np.isfinite(losses).all():
        raise AssertionError(f"[gnn] graphsage-reddit losses not finite: {losses}")
    prof = gnn_step_profile(torch, np, "[gnn] graphsage-reddit minibatch_lg step",
                            lambda: step(params, state, batch)) if device == "cuda" else {}
    log(f"[gnn] graphsage-reddit minibatch_lg, {GNN_SAGE_STEPS} AdamW steps of "
        f"{cell['batch_nodes']} seeds (fanout {cell['fanout']}, padded to {n_pad} nodes / "
        f"{e_pad} edges): host sampling {np.median(host_ms[1:]):.1f} ms, transfer + step "
        f"{np.median(dev_ms):.1f} ms (medians); losses {[round(l, 4) for l in losses]}; "
        f"profiled step {prof}")
    records.append(dict(graph="reddit_shaped", arch="graphsage-reddit", cell="minibatch_lg",
                        steps=GNN_SAGE_STEPS, host_sampling_ms=host_ms[1:], step_ms=dev_ms,
                        host_sampling_ms_median=float(np.median(host_ms[1:])),
                        step_ms_median=float(np.median(dev_ms)), losses=losses,
                        csr_build_s=t_csr, card_vs_cpu=fig, **prof))
    del params, state, batch, sampler, feats

    for arch, cell_name in (("gcn-cora", "full_graph_sm"), ("gin-tu", "molecule")):
        fam = get_arch(arch)
        meta = fam.cells[cell_name].meta
        cfg = fam.cfg_for(cell_name)
        optimizer, step = fam.train_objects(cell_name)
        gen.manual_seed(seed + 23)
        params = gnn_mod.init_gnn(cfg, gen, device)
        state = init_train_state(params, optimizer, TrainConfig())
        if cell_name == "molecule":
            s, d, gid = molecule_batch_graph(meta["n_nodes"], meta["n_edges"], meta["batch"],
                                             seed=seed)
            n = meta["n_nodes"] * meta["batch"]
            host = dict(src=s, dst=d, graph_id=gid, labels=rng.integers(
                0, meta["n_classes"], meta["batch"]))
        else:
            n = meta["n_nodes"]
            host = dict(src=rng.integers(0, n, meta["n_edges"]),
                        dst=rng.integers(0, n, meta["n_edges"]),
                        labels=rng.integers(0, meta["n_classes"], n))
        host["x"] = rng.standard_normal((n, meta["d_feat"])).astype(np.float32)
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        ms, losses = [], []
        for _ in range(GNN_SMALL_STEPS):
            t0 = time.perf_counter()
            _, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"[gnn] {arch} losses not finite and falling: {losses}")
        log(f"[gnn] {arch} {cell_name}: {GNN_SMALL_STEPS} AdamW steps, {np.median(ms):.2f} ms "
            f"a step (median), losses {losses[0]:.4f} -> {losses[-1]:.4f}")
        records.append(dict(graph=cell_name, arch=arch, cell=cell_name, steps=len(ms),
                            step_ms=ms, step_ms_median=float(np.median(ms)),
                            losses=losses))
        del params, state, batch
    return records


def _rotation(torch, seed, device):
    A = torch.randn((3, 3), generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    Q, Rm = torch.linalg.qr(A)
    Q = Q * torch.sign(torch.diag(Rm))
    if torch.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q.float().to(device)


def molecule_positions(np, rng, n_molecules, n_atoms):
    """Atom positions [n_molecules * n_atoms, 3] (float32), each molecule a
    jittered grid (NEQUIP_SPACING, NEQUIP_JITTER)."""
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(4), indexing="ij"),
                    -1).reshape(-1, 3)[:n_atoms] * NEQUIP_SPACING
    return np.concatenate([
        grid + rng.uniform(-NEQUIP_JITTER, NEQUIP_JITTER, (n_atoms, 3))
        for _ in range(n_molecules)]).astype(np.float32)


def nequip_path(torch, np, seed, device):
    """nequip at the molecule cell (128 molecules x 30 atoms, the published
    5 layers, 32 channels, l_max 2): energies invariant and forces
    equivariant under a seeded rotation at the initial weights (each
    molecule's cutoff graph, TF32 off; ``test_models.py``'s tolerance),
    then energy-MSE AdamW steps on the cell's random molecule edges."""
    from repro_torch.configs import get_arch
    from repro_torch.data.generators import molecule_batch_graph
    from repro_torch.models import nequip as nq
    from repro_torch.train.train_step import TrainConfig, init_train_state

    rng = np.random.default_rng(seed + 31)
    fam = get_arch("nequip")
    cfg = fam.cfg
    meta = fam.cells["molecule"].meta
    G, A = meta["batch"], meta["n_nodes"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 32)
    params = nq.init_nequip(cfg, gen, device)
    pos = molecule_positions(np, rng, G, A)
    species = torch.as_tensor(rng.integers(0, cfg.n_species, G * A), device=device)
    gid = np.repeat(np.arange(G), A)

    # E(3): per-molecule cutoff graphs, no self edges
    ss, dd = [], []
    for g in range(G):
        p = pos[g * A:(g + 1) * A]
        dm = np.linalg.norm(p[:, None] - p[None], axis=-1)
        a, b = np.nonzero((dm < cfg.cutoff) & (dm > 0))
        ss.append(a + g * A)
        dd.append(b + g * A)
    eq = dict(species=species, pos=torch.as_tensor(pos, device=device),
              graph_id=torch.as_tensor(gid, device=device),
              src=torch.as_tensor(np.concatenate(ss), device=device),
              dst=torch.as_tensor(np.concatenate(dd), device=device), n_graphs=G)
    Q = _rotation(torch, seed + 10, device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            e1 = nq.nequip_forward(params, eq, cfg)
            e2 = nq.nequip_forward(params, {**eq, "pos": eq["pos"] @ Q.T}, cfg)
        _, f1 = nq.nequip_energy_forces(params, eq, cfg)
        _, f2 = nq.nequip_energy_forces(params, {**eq, "pos": eq["pos"] @ Q.T}, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    e1, e2 = e1.cpu().numpy(), e2.cpu().numpy()
    f1r, f2 = (f1 @ Q.T).cpu().numpy(), f2.cpu().numpy()
    np.testing.assert_allclose(e2, e1, **NEQUIP_E3_TOL["energy"])
    np.testing.assert_allclose(f2, f1r, **NEQUIP_E3_TOL["forces"])
    over = lambda got, want, tol: float(
        (np.abs(got - want) / (tol["atol"] + tol["rtol"] * np.abs(want))).max())
    fig = dict(energy_max_abs=float(np.abs(e2 - e1).max()),
               forces_max_abs=float(np.abs(f2 - f1r).max()),
               energy_err_over_tol=over(e2, e1, NEQUIP_E3_TOL["energy"]),
               forces_err_over_tol=over(f2, f1r, NEQUIP_E3_TOL["forces"]),
               edges=int(eq["src"].shape[0]))
    log(f"[nequip] {G} molecules rotated on the {device}: energies invariant and forces "
        f"equivariant within {NEQUIP_E3_TOL}: {fig}")

    optimizer, step = fam.train_objects("molecule")
    state = init_train_state(params, optimizer, TrainConfig())
    s, d, gid_cell = molecule_batch_graph(A, meta["n_edges"], G, seed=seed)
    batch = dict(species=species, pos=eq["pos"],
                 src=torch.as_tensor(s, device=device), dst=torch.as_tensor(d, device=device),
                 graph_id=torch.as_tensor(gid_cell, device=device),
                 energy_target=torch.as_tensor(rng.standard_normal(G).astype(np.float32),
                                               device=device))
    ms, losses = [], []
    for _ in range(NEQUIP_STEPS):
        t0 = time.perf_counter()
        _, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"[nequip] losses not finite and falling: {losses}")
    log(f"[nequip] molecule cell ({G} x {A} atoms, {len(s)} edges, {cfg.n_layers} layers, "
        f"{cfg.d_hidden} channels, l_max {cfg.l_max}): {NEQUIP_STEPS} energy-MSE AdamW "
        f"steps, {np.median(ms):.1f} ms a step (median), losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    return [dict(graph="molecule", arch="nequip", cell="molecule", steps=len(ms),
                 step_ms=ms, step_ms_median=float(np.median(ms)), losses=losses, e3=fig)]


def mind_path(torch, np, seed, device):
    """mind at its published 1e8 x 64 float32 item table: serve_p99 (B 512)
    timed over MIND_SERVE_CALLS calls, retrieval_cand (1e6 candidates, top
    100: the ids equal a stable sort of the same scores on the CPU); then
    train_batch (65,536 users) on a table cut to MIND_TRAIN_ITEMS rows."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import mind as mm
    from repro_torch.train.train_step import TrainConfig, init_train_state

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed + 41)
    fam = get_arch("mind")
    cfg = fam.cfg
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 42)
    t0 = time.perf_counter()
    params = mm.init_mind(cfg, gen, device)
    sync()
    log(f"[mind] item table {cfg.n_items} x {cfg.embed_dim} float32 "
        f"({cfg.n_items * cfg.embed_dim * 4} bytes) drawn in {time.perf_counter() - t0:.2f} s")

    def histories(B, n_items=cfg.n_items):
        h = rng.integers(1, n_items, (B, cfg.hist_len))
        h[np.arange(B) % 4 == 0, cfg.hist_len // 2:] = 0     # some short histories
        return torch.as_tensor(h, device=device)

    B = fam.cells["serve_p99"].meta["batch"]
    batch = {"hist": histories(B)}
    lat = []
    with torch.no_grad():
        for _ in range(MIND_SERVE_CALLS):
            sync()
            t0 = time.perf_counter()
            out = mm.serve_step(params, batch, cfg)
            sync()
            lat.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(out).all()) or tuple(out.shape) != (B, cfg.n_interests,
                                                                   cfg.embed_dim):
        raise AssertionError(f"[mind] serve_p99: interests {tuple(out.shape)} not finite")
    rec_serve = dict(graph="recsys", arch="mind", cell="serve_p99", batch=B,
                     ms_median=float(np.median(lat)), ms_p99=float(np.quantile(lat, 0.99)),
                     calls=len(lat))
    log(f"[mind] serve_p99 (B {B}): {np.median(lat):.3f} ms median, "
        f"{np.quantile(lat, 0.99):.3f} ms p99 over {len(lat)} calls")

    meta = fam.cells["retrieval_cand"].meta
    cands = torch.as_tensor(rng.integers(1, cfg.n_items, meta["n_candidates"]), device=device)
    rb = {"hist": histories(meta["batch"]), "candidates": cands}
    with torch.no_grad():
        mm.retrieval_step(params, rb, cfg, top_k=MIND_TOP_K)   # warm
        sync()
        t0 = time.perf_counter()
        vals, ids = mm.retrieval_step(params, rb, cfg, top_k=MIND_TOP_K)
        sync()
        r_ms = (time.perf_counter() - t0) * 1e3
        scores = mm.score_candidates(params, mm.user_tower(params, rb["hist"], cfg),
                                     rb["candidates"]).cpu()
    want_v, want_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    if not torch.equal(ids.cpu(), want_i[:, :MIND_TOP_K]) or not torch.equal(
            vals.cpu(), want_v[:, :MIND_TOP_K]):
        raise AssertionError("[mind] retrieval ids differ from a stable sort of the "
                             "scores on the CPU")
    ties = int((want_v[0, 1:MIND_TOP_K] == want_v[0, :MIND_TOP_K - 1]).sum())
    log(f"[mind] retrieval_cand ({meta['n_candidates']} candidates, top {MIND_TOP_K}): "
        f"{r_ms:.2f} ms warm; ids equal the CPU's stable sort ({ties} tied neighbours in "
        f"the top)")
    rec_ret = dict(graph="recsys", arch="mind", cell="retrieval_cand",
                   candidates=meta["n_candidates"], ms=r_ms, tied_neighbours=ties)
    del params, out, rb, scores, cands
    if device == "cuda":
        torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, n_items=MIND_TRAIN_ITEMS)
    gen.manual_seed(seed + 43)
    params = mm.init_mind(tcfg, gen, device)
    optimizer, step = fam.train_objects(tcfg)
    state = init_train_state(params, optimizer, TrainConfig())
    B = fam.cells["train_batch"].meta["batch"]
    ms, losses = [], []
    for _ in range(MIND_TRAIN_STEPS):
        tb = {"hist": histories(B, tcfg.n_items),
              "target": torch.as_tensor(rng.integers(1, tcfg.n_items, B), device=device),
              "negatives": torch.as_tensor(rng.integers(1, tcfg.n_items,
                                                        (B, tcfg.n_negatives)),
                                           device=device)}
        sync()
        t0 = time.perf_counter()
        _, state, m = step(params, state, tb)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(losses).all():
        raise AssertionError(f"[mind] train_batch losses not finite: {losses}")
    log(f"[mind] train_batch (B {B}, {tcfg.n_negatives} negatives, table cut to "
        f"{tcfg.n_items} rows): {MIND_TRAIN_STEPS} AdamW steps, {ms} ms, losses {losses}")
    rec_train = dict(graph="recsys", arch="mind", cell="train_batch", batch=B,
                     step_ms=ms, losses=losses, cut=f"item table {tcfg.n_items} rows of "
                     f"{cfg.n_items}")
    del params, state, tb
    return [rec_serve, rec_ret, rec_train]


@contextlib.contextmanager
def phase_clock(torch, name):
    """Logs a phase's wall time and its peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"phase {name}: {time.perf_counter() - t0:.2f} s wall, peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")


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
    # cuBLAS is deterministic only with a fixed workspace (the training
    # phase's resume check runs under torch.use_deterministic_algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    with phase_clock(torch, "graph paths"):
        for name, g in graphs.items():
            tger, fields, windows, sources = contexts[name]
            records += main_path(torch, np, name, g, tger, fields, windows, sources)
            records += pagerank_path(torch, np, name, g, tger, fields, windows, failures)
            records += analytics_path(torch, np, name, g, tger, fields, windows["narrow"],
                                      sources)
            records += paths_path(torch, np, name, g, tger, fields, windows, sources)
        # multi-tenant serving and the ring streams (counted too)
        records += serving_path(torch, np, "power_law", graphs["power_law"],
                                contexts["power_law"][0], contexts["power_law"][1],
                                failures)
        for name, access in (("transit", "index"), ("power_law", "hybrid")):
            tger, fields, _, _ = contexts[name]
            records += ring_stream(torch, np, name, graphs[name], tger, fields, access)
    counts = launch_counts()
    log(f"graph paths launches: {counts}")
    # -- the frontier ladder, counted on its own ------------------------------
    reset_launch_counts()
    with phase_clock(torch, "ladder"):
        ladder_records, laddered_k1 = ladder_path(torch, np, graphs, contexts, failures, tem)
    ladder_counts = launch_counts()
    log(f"ladder phase launches: {ladder_counts}")
    if ladder_counts["segment_min_tiles"] <= 0:
        raise AssertionError("K1 was never launched in the ladder phase")
    records += ladder_records
    # -- the cold store and the daemon, counted on their own -------------------
    reset_launch_counts()
    with phase_clock(torch, "history/daemon"):
        records += history_daemon_path(torch, np, graphs, contexts, failures, args.seed)
    history_counts = launch_counts()
    log(f"history/daemon phase launches: {history_counts}")
    for kernel in ("segment_min_tiles", "segment_spmm_tiles"):
        if history_counts[kernel] <= 0:
            raise AssertionError(f"{kernel} was never launched in the daemon phase")
    # -- distributed serving and the edge-partitioned engine, counted ---------
    reset_launch_counts()
    with phase_clock(torch, "distributed"):
        records += distributed_path(torch, np, graphs, contexts, failures, args.seed)
    dist_counts = launch_counts()
    log(f"distributed phase launches: {dist_counts}")
    for kernel in ("segment_min_tiles", "segment_spmm_tiles"):
        if dist_counts[kernel] <= 0:
            raise AssertionError(f"{kernel} was never launched in the distributed phase")
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
    with torch.no_grad(), phase_clock(torch, "lm serving"):
        lm_records, lm_counts = lm_path(torch, np, model, args.seed)
    del model
    records += lm_records
    counts["decode_attention"] = lm_counts["decode_attention"]
    # -- MoE: moe_ffn, K4 at its decode shape, serving (counted), training ---
    with phase_clock(torch, "moe"):
        moe_records, moe_k4, moe_counts = moe_path(torch, np, args.seed, k4)
    records += moe_records
    rows[3]["moe_shape"] = moe_k4
    log(f"MoE serving phase launches: {moe_counts}")
    # -- LM training (no port kernel on its path; counted all the same) ------
    reset_launch_counts()
    with phase_clock(torch, "training"):
        records += train_path(torch, np, args.seed)
    train_counts = launch_counts()
    log(f"training phase launches: {train_counts}")
    # -- the paper's cells at 1e9 edges (no port kernel on the path) ----------
    del graphs, contexts, layouts, g, plan
    torch.cuda.empty_cache()
    reset_launch_counts()
    with phase_clock(torch, "kairos cells"):
        records += kairos_path(torch, np, args.seed)
    kairos_counts = launch_counts()
    log(f"kairos phase launches: {kairos_counts}")
    # -- GNN, NequIP and MIND at their published widths (no port kernel) ------
    torch.cuda.empty_cache()
    reset_launch_counts()
    with phase_clock(torch, "models"):
        records += gnn_paths(torch, np, args.seed, "cuda")
        records += nequip_path(torch, np, args.seed, "cuda")
        records += mind_path(torch, np, args.seed, "cuda")
    model_counts = launch_counts()
    log(f"models phase launches: {model_counts}")
    # -- sharded training on a one-rank NCCL mesh (no port kernel) ------------
    torch.cuda.empty_cache()
    reset_launch_counts()
    with phase_clock(torch, "sharded training"):
        records += sharded_train_path(torch, np, args.seed)
    sharded_counts = launch_counts()
    log(f"sharded training phase launches: {sharded_counts}")
    # -- the examples on the card against the CPU (K4 in serve_lm) -------------
    reset_launch_counts()
    with phase_clock(torch, "examples"):
        example_records, example_counts = examples_path(torch, np, args.seed)
    records += example_records
    log(f"examples phase launches: {example_counts}")
    for label, got in (("kairos", kairos_counts), ("models", model_counts),
                       ("sharded training", sharded_counts)):
        if any(got.values()):
            raise AssertionError(f"a port kernel launched in the {label} phase, whose "
                                 f"reference runs no Pallas kernel: {got}")
    # the kernels' instances on the main paths: registers, spills
    for row in rows[:2]:  # K1: its one-window and its windowed instance
        row["ptxas"] = {k: v for k, v in ptxas["temporal_edgemap"].items()
                        if k.startswith(f"{row['name']}_kernel")}
    rows[2]["ptxas"] = ptxas["segment_spmm"].get("segment_spmm_tiles_kernel")
    rows[3]["ptxas"] = {f"<{t}, G={G}>": ptxas["decode_attention"].get(
        f"decode_attention_kernel<{t}, {v}, {G}>") for t, v in (("bf16", 8), ("f32", 4))
        for G in (cfg.n_heads // cfg.n_kv_heads, moe_k4["shape"]["G"])}
    for row in rows:
        row["ladder_launches"] = ladder_counts[row["name"]]
        row["history_daemon_launches"] = history_counts[row["name"]]
        row["distributed_launches"] = dist_counts[row["name"]]
        row["moe_serving_launches"] = moe_counts[row["name"]]
        row["training_launches"] = train_counts[row["name"]]
        row["kairos_launches"] = kairos_counts[row["name"]]
        row["models_launches"] = model_counts[row["name"]]
        row["sharded_training_launches"] = sharded_counts[row["name"]]
        row["examples_launches"] = example_counts[row["name"]]
        row["launches"] = (counts[row["name"]] + row["ladder_launches"]
                           + row["history_daemon_launches"]
                           + row["distributed_launches"] + row["moe_serving_launches"]
                           + row["examples_launches"])
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
