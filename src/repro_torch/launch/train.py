"""The trainer: data pipeline -> train step -> checkpoint / resume ->
straggler monitoring (the port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --scale smoke --batch 8 --seq 64 --ckpt /tmp/ckpt [--device cpu]

Everything runs on the first CUDA card unless ``--device`` names another;
without a card and without ``--device`` it raises.  It prints the
reference's lines and returns the losses.

One deliberate difference: ``--resume`` restores the latest checkpoint and
then skips the batches of the steps already taken, so a resumed run sees
the batches an uninterrupted one would (the reference restarts the corpus
at its first batch).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import MarkovCorpus
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.models import transformer as tf
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.optimizer import make_optimizer, warmup_cosine
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
from repro_torch.tree import tree_map


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", choices=["none", "int8", "topk"], default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("train.py drives LM archs; see examples/ for others")
    cfg = spec.smoke_cfg if args.scale == "smoke" else spec.cfg

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    model = tf.init_lm(cfg, gen, device)
    params = model.params
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={args.arch} scale={args.scale} params={n_params/1e6:.2f}M")

    optimizer = make_optimizer(
        "adamw", warmup_cosine(args.lr, args.steps // 10 + 1, args.steps)
    )
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        compression=CompressionConfig(kind=args.compression),
    )
    step_fn = make_train_step(lambda p, b: tf.loss_fn(model, b), optimizer, tcfg)
    state = init_train_state(params, optimizer, tcfg)

    mgr = CheckpointManager(args.ckpt, keep=3, async_save=True) if args.ckpt else None
    start_step = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        restored, start_step = mgr.restore({"params": params, "state": state})
        with torch.no_grad():
            tree_map(lambda p, r: p.copy_(r), params, restored["params"])
        state = restored["state"]
        print(f"resumed from step {start_step}")

    corpus = MarkovCorpus(vocab=cfg.vocab, seed=args.seed)
    batches = corpus.batches(args.batch, args.seq, seed=args.seed + 1)
    for _ in range(start_step):
        next(batches)
    monitor = StragglerMonitor(threshold=3.0, policy="flag")

    losses = []
    for step_idx in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=device) for k, v in next(batches).items()}
        monitor.step_start()
        params, state, metrics = step_fn(params, state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        action = monitor.step_end()
        losses.append(metrics["loss"])
        if action:
            print(f"[straggler] step {step_idx}: {action} "
                  f"(median {monitor.median*1e3:.0f} ms)")
        if step_idx % args.log_every == 0 or step_idx == args.steps - 1:
            print(f"step {step_idx:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f}")
        if mgr and (step_idx + 1) % args.ckpt_every == 0:
            mgr.save(step_idx + 1, {"params": params, "state": state}, blocking=False)
    if mgr:
        mgr.save(args.steps, {"params": params, "state": state}, blocking=True)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"median step {monitor.median*1e3:.0f} ms")
    return losses


if __name__ == "__main__":
    main()
