"""Serve a language model with continuous batching (the LM mode of
``repro/launch/serve.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch smollm-135m]
        [--requests 16] [--slots 4] [--max-new 12] [--prompt-len 16]
        [--max-seq 64] [--seed 0] [--device cpu]

As in the reference it serves the architecture's reduced config
(``smoke_cfg``) with random weights from ``--seed``, on the first CUDA card
unless ``--device`` names another; without a card and without
``--device`` it raises.  The graph and daemon modes are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import EngineStats, Request, ServeEngine


def main(argv=None) -> EngineStats:
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
    args = ap.parse_args(argv)

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


if __name__ == "__main__":
    main()
