#!/usr/bin/env python3
"""Readings for a cell's limits: for each seed, a short window of the
cell's own load on the card, then the numbers ``correct`` compares, of
the program's answers and of the control (the plain reference computed
in the configuration's lower precision, put in the program's place).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--requests 4] [--seconds 5]

Each seed is one set-up and one window in this process; a line of JSON a
seed goes to standard output."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from portbench import bench  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = bench.run_cell(ROOT, args.workload, seed, args.seconds, False, t_process=t0,
                             control="lowp", samples=args.requests,
                             requests_max=args.requests)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": res["program"], "control": res["control"],
                          "limits": {k: c["limit"] for k, c in res["checks"].items()},
                          "correct": res["correct"], "seconds": time.perf_counter() - t0,
                          "device": res["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
