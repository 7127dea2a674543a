"""Time the port's dense temporal k-core against other versions of its
module (``src/repro_torch/core/algorithms/kcore.py``) on the card, in turns.

    python3 scripts/compare_dense_kcore.py [--seed S] [--reps N] LABEL=PATH ...

Every version runs in one process on chip_smoke.py's wiki-talk-sized graphs
(1,140,149 vertices, 7,833,140 edges; power_law and transit from ``--seed``)
over the same views, windows and k.  Each PATH is loaded as a module beside
this tree's and resolves its imports against this tree's package, so what
differs between the versions is the k-core module's own rounds.  For each
graph and window the versions run ``--reps`` times in alternating order
(forward, backward, ...; host clock around a synced call, one warm-up call
each) and their results must be equal.  Prints one JSON line per (graph,
window) with every version's median, min and max ms, and the card's name
and power limit as ``nvidia-smi`` gives them.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load(label: str, path: str):
    spec = importlib.util.spec_from_file_location(f"kcore_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", metavar="LABEL=PATH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_dense_kcore: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import plan_query
    from repro_torch.core.algorithms import kcore
    from repro_torch.core.edgemap import view_for_plan
    from repro_torch.data.generators import power_law_temporal_graph, transit_temporal_graph

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    versions = {"this": kcore}
    for item in args.others:
        label, path = item.split("=", 1)
        versions[label] = load(label, path)

    sync = torch.cuda.synchronize
    for name, fn in (("power_law", power_law_temporal_graph),
                     ("transit", transit_temporal_graph)):
        g = fn(cs.WIKI_TALK_VERTICES, cs.WIKI_TALK_EDGES, seed=args.seed)
        tger, _, windows, _ = cs.graph_context(torch, np, name, g)
        for wname, window in windows.items():
            plan = plan_query(g, tger, window, access="scan", backend="xla_segment")
            edges = view_for_plan(g, tger, window, plan)
            one = np.asarray([window], np.int32)

            def run(mod):
                return mod.temporal_kcore_over_view(edges, one, plan=plan,
                                                    n_vertices=g.n_vertices,
                                                    k=cs.KCORE_K)

            ref = run(kcore)
            for mod in versions.values():
                if not torch.equal(run(mod), ref):
                    raise AssertionError(f"[{name}] {wname}: versions disagree")
            ms = {label: [] for label in versions}
            for label in cs.alternating(versions, args.reps):
                sync()
                t0 = time.perf_counter()
                run(versions[label])
                sync()
                ms[label].append((time.perf_counter() - t0) * 1e3)
            out = dict(graph=name, window=wname, k=cs.KCORE_K, alive=int(ref.sum()),
                       reps=args.reps, **{label: cs.spread(np, v) for label, v in ms.items()})
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
