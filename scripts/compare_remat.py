"""Time smollm-135m's train step with activation recompute on and off, and
against other source trees, in turns, on the card.

    python3 scripts/compare_remat.py [--steps N] [--seed S] [--turns T] [LABEL=DIR ...]

The variants are this tree with recompute on (``on``) and off (``off``)
and, for each ``LABEL=DIR`` (the root of another checkout of this
repository, for example a ``git archive`` of a parent commit unpacked
under ``build/``), that tree's step without recompute (a tree whose
``LMConfig`` has no ``remat`` field has none).  Every run of a variant is
a fresh process (``--worker``): it draws the weights from ``--seed`` at the
published config (30 layers, bfloat16) with its tree's ``init_lm``, takes a
batch of 8 x 512 and trains with AdamW through ``LMFamily.train_objects``
under ``torch.use_deterministic_algorithms``.  Its first step's loss,
gradient norm and parameters (hashed) must be the same, bit for bit, in
every run of every variant.  Then N timed steps: median ms a step, peak
memory, and one profiled step's device busy time and kernel launches.
The variants run in the order on, off, others..., others reversed, off,
on, repeated ``--turns`` times.  Prints the card's name and power limit as
``nvidia-smi`` gives them, one JSON line per run and a summary line with
each variant's means over its runs.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(tree: str, remat: bool, seed: int, steps: int) -> dict:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [str(Path(tree).resolve() / "src")]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import TrainConfig, init_train_state
    from repro_torch.tree import tree_leaves

    torch.use_deterministic_algorithms(True)
    fam = get_arch("smollm-135m")
    cfg = fam.cfg
    if any(f.name == "remat" for f in dataclasses.fields(cfg)):
        cfg = dataclasses.replace(cfg, remat=remat)
    elif remat:
        raise ValueError(f"{tree}: LMConfig has no remat field")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = tf.init_lm(cfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab, (8, 512), generator=gen, device="cuda",
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    opt, step = fam.train_objects(model)
    state = init_train_state(model.params, opt, TrainConfig())
    _, state, metrics = step(model.params, state, batch)
    torch.cuda.synchronize()
    sha = hashlib.sha256()
    for p in tree_leaves(model.params):
        sha.update(p.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    first = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                 params_sha=sha.hexdigest()[:16])
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, _ = step(model.params, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model.params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(first=first, median_ms=float(np.median(ms)), ms=ms, peak_bytes=peak,
                profiled_wall_ms=wall,
                busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
                launches=sum(e.count for e in kernels))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", metavar="LABEL=DIR")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--remat", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.remat, args.seed, args.steps)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("compare_remat: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    variants = {"on": (str(ROOT), True), "off": (str(ROOT), False),
                **{k: (d, False) for k, d in (o.split("=", 1) for o in args.others)}}
    names = list(variants)
    order = (names + names[::-1]) * args.turns
    runs = {k: [] for k in variants}
    for name in order:
        tree, remat = variants[name]
        out = subprocess.run([sys.executable, __file__, "--worker", tree, "--seed",
                              str(args.seed), "--steps", str(args.steps)]
                             + (["--remat"] if remat else []),
                             capture_output=True, text=True, check=True, timeout=900)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        runs[name].append(rec)
        print(json.dumps({"variant": name, **rec}), flush=True)
    firsts = {json.dumps(r["first"], sort_keys=True) for rs in runs.values() for r in rs}
    summary = {k: {m: sum(r[m] for r in rs) / len(rs)
                   for m in ("median_ms", "peak_bytes", "busy_ms", "launches")}
               for k, rs in runs.items()}
    same = len(firsts) == 1
    print(json.dumps({"summary": summary, "bit_identical_first_step": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
