"""Time LM serving (phi4-mini-3.8b at its published widths) on this tree and
on other source trees, on the card, in turns.

    python3 scripts/compare_lm_serving.py [--seed S] [--turns N] LABEL=DIR ...

Each DIR is the root of another checkout of this repository (for example a
``git archive`` of a parent commit unpacked under ``build/``).  Every turn
runs one version in a fresh process (``--worker``): it builds K4 from that
tree's source into that tree's ``build/``, draws phi4-mini-3.8b (32 layers,
bfloat16) from ``--seed`` with that tree's ``init_lm``, and serves
``chip_smoke.py``'s 16 requests (prompts of 16-512 tokens, budgets up to
64) on a ``ServeEngine`` of 8 slots x 2048 positions after one warm-up
prefill and decode step, then one more decode step under the profiler
(its wall time, device busy time and kernel launches).  The versions run
in the order this, others..., others reversed, this, repeated ``--turns``
times.  Prints the card's name and power limit as ``nvidia-smi`` gives
them, one JSON line per turn (ms per decode step: median and mean; prefill
ms per request: mean; decode tokens/s; the profiled step; a hash of the
served tokens) and a summary line with each
version's means over its turns.  A version's served tokens must be the
same in each of its turns (two trees may draw their random weights in
another order, and then serve other tokens at the same shapes).  Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(tree: str, seed: int) -> dict:
    tree = Path(tree).resolve()
    sys.path[:0] = [str(tree / "src")]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    from repro_torch.serve.engine import Request, ServeEngine

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # this tree's request set and sizes

    build.library("decode_attention")
    cfg = get_arch(cs.LM_ARCH).cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = init_lm(cfg, gen, "cuda")
    rng = np.random.default_rng(seed)
    plens = rng.integers(cs.LM_PROMPT_LEN[0], cs.LM_PROMPT_LEN[1] + 1, cs.LM_REQUESTS)
    budgets = rng.integers(2, cs.LM_MAX_NEW + 1, cs.LM_REQUESTS)
    budgets[3], budgets[7], budgets[11] = 1, 0, cs.LM_MAX_NEW
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=int(b)) for i, (n, b) in enumerate(zip(plens, budgets))]
    with torch.no_grad():
        warm = torch.as_tensor(reqs[0].prompt[:64], device="cuda")[None]
        _, cache = prefill(model, warm, max_seq=128)
        decode_step(model, cache, warm[:, -1], torch.tensor([warm.shape[1]], device="cuda"))
        torch.cuda.synchronize()
        del cache
        engine = ServeEngine(model, batch_slots=cs.LM_SLOTS, max_seq=cs.LM_MAX_SEQ)
        prefill_ms, decode_ms = [], []

        def timed(fn, out):
            def run(*args):  # each phase ends in a host read of its argmax
                t = time.perf_counter()
                r = fn(*args)
                out.append((time.perf_counter() - t) * 1e3)
                return r
            return run

        engine._prefill = timed(engine._prefill, prefill_ms)
        engine._decode = timed(engine._decode, decode_ms)
        for r in reqs:
            engine.submit(r)
        engine.run()
    tokens = np.asarray([t for r in reqs for t in r.generated], np.int64)
    decode_tokens = engine.stats.tokens_generated - len(prefill_ms)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        engine._decode()                       # one more step, over the last slots
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(profiled_decode_ms=decode_ms.pop(),
                profiled_decode_busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
                profiled_decode_launches=sum(e.count for e in kernels),
                decode_ms_median=float(np.median(decode_ms)),
                decode_ms_mean=float(np.mean(decode_ms)),
                prefill_ms_mean=float(np.mean(prefill_ms)),
                decode_tokens_per_s=decode_tokens / (sum(decode_ms) / 1e3),
                steps=engine.stats.steps,
                tokens_sha=hashlib.sha256(tokens.tobytes()).hexdigest()[:16])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", metavar="LABEL=DIR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("compare_lm_serving: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    versions = {"this": str(ROOT), **dict(o.split("=", 1) for o in args.others)}
    others = [k for k in versions if k != "this"]
    order = (["this"] + others + others[::-1] + ["this"]) * args.turns
    runs = {k: [] for k in versions}
    for label in order:
        out = subprocess.run([sys.executable, __file__, "--worker", versions[label],
                              "--seed", str(args.seed)], capture_output=True, text=True,
                             check=True, timeout=900)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        runs[label].append(rec)
        print(json.dumps({"version": label, **rec}), flush=True)
    summary = {k: {m: sum(r[m] for r in rs) / len(rs)
                   for m in ("decode_ms_median", "prefill_ms_mean", "decode_tokens_per_s")}
               for k, rs in runs.items()}
    steady = all(len({r["tokens_sha"] for r in rs}) == 1 for rs in runs.values())
    print(json.dumps({"summary": summary, "same_tokens_per_version": steady}), flush=True)
    return 0 if steady else 1


if __name__ == "__main__":
    sys.exit(main())
