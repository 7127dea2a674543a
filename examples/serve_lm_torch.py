"""Batched LM serving on the PyTorch port: continuous batching with the
``ServeEngine`` (the counterpart of ``examples/serve_lm.py``).  On the card
every decode step's attention is the flash-decode kernel K4.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

It runs on the first CUDA card unless ``--device`` names another.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch import serve as serve_mod  # noqa: E402


def run(requests=12, slots=4, max_new=10, arch="smollm-135m", device=None):
    """Serve ``requests`` random prompts; returns the ``EngineStats``."""
    argv = ["--arch", arch, "--requests", str(requests), "--slots", str(slots),
            "--max-new", str(max_new)]
    return serve_mod.main(argv + (["--device", str(device)] if device is not None else []))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
