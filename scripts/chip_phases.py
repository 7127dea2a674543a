"""Run some of ``chip_smoke.py``'s phases alone on the card, in one process.

    python3 scripts/chip_phases.py [--seed S] PHASE ...
        (PHASE: kairos, models, sharded, examples, dryrun)

``kairos`` is the paper's six cells at |V| = 1e7, |E| = 1e9
(``kairos_path``); ``models`` is graphsage-reddit, gcn-cora, gin-tu, nequip
and mind at their published widths (``gnn_paths``, ``nequip_path``,
``mind_path``); ``sharded`` is sharded training on a one-rank NCCL mesh
(``sharded_train_path``); ``examples`` runs ``examples/*_torch.py`` on the
card against the CPU (``examples_path``); ``dryrun`` is the dry run of
every cell on the 256- and 512-rank production meshes, in a subprocess,
against the card's memory (``dryrun_path``; ``--dryrun-out DIR`` keeps its
records).  Only ``examples`` reaches a port kernel (K4, built at its first
launch).  Each
phase runs with chip_smoke.py's checks, logs its wall time and peak device
memory, and its records print as ``query`` JSON lines; the card's name and
power limit come first, as ``nvidia-smi`` gives them.  A profile read here
is not disturbed by the other phases of a whole ``chip_smoke.py`` run.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="+",
                    choices=["kairos", "models", "sharded", "examples", "dryrun"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dryrun-out", metavar="DIR")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # cuBLAS is deterministic only with a fixed workspace (the sharded
    # phase's resume check runs under torch.use_deterministic_algorithms)
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    records = []
    for phase in args.phases:
        with cs.phase_clock(torch, phase):
            if phase == "kairos":
                records += cs.kairos_path(torch, np, args.seed)
            elif phase == "sharded":
                records += cs.sharded_train_path(torch, np, args.seed)
            elif phase == "examples":
                records += cs.examples_path(torch, np, args.seed)[0]
            elif phase == "dryrun":
                records += cs.dryrun_path(args.dryrun_out)
            else:
                records += cs.gnn_paths(torch, np, args.seed, "cuda")
                records += cs.nequip_path(torch, np, args.seed, "cuda")
                records += cs.mind_path(torch, np, args.seed, "cuda")
        torch.cuda.empty_cache()
    for rec in records:
        print("query " + json.dumps(rec, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
