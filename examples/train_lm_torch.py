"""End-to-end training on the PyTorch port: train smollm-135m on the
synthetic Markov corpus, with checkpointing and straggler monitoring (the
counterpart of ``examples/train_lm.py``).

Defaults are the reduced smollm config; pass --full for the real
smollm-135m at 30 layers.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]

It runs on the first CUDA card unless ``--device`` names another.  The
checkpoints go to ``--ckpt`` (by default ``repro_torch_train_lm`` in the
temporary directory).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch import train as train_mod  # noqa: E402


def run(steps=200, full=False, device=None, ckpt=None, batch=16, seq=64):
    """Train and return the per-step losses."""
    ckpt = ckpt or os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    argv = [
        "--arch", "smollm-135m",
        "--scale", "full" if full else "smoke",
        "--steps", str(steps),
        "--batch", str(batch), "--seq", str(seq), "--lr", "3e-3",
        "--ckpt", ckpt, "--ckpt-every", "100",
    ]
    return train_mod.main(argv + (["--device", str(device)] if device is not None else []))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="train the real 135M config")
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)
    losses = run(args.steps, args.full, args.device, args.ckpt)
    assert losses[-1] < losses[0], "loss must decrease"
    print("OK: loss decreased", losses[0], "->", losses[-1])
    return losses


if __name__ == "__main__":
    main()
