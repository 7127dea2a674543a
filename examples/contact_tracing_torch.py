"""Contact tracing over a temporal interaction graph on the PyTorch port
(the counterpart of ``examples/contact_tracing.py``, with the same output).

Builds a bursty synthetic contact network, finds everyone reachable from a
patient-zero within an exposure window (earliest arrival = earliest possible
infection time), ranks super-spreaders by temporal betweenness, and shows
the selective-indexing decision flipping between scan and TGER as the
window narrows.

  PYTHONPATH=src python examples/contact_tracing_torch.py [--device cpu]

It runs on the first CUDA card unless ``--device`` names another.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import build_tger, decision_for  # noqa: E402
from repro_torch.core.algorithms import earliest_arrival, temporal_betweenness  # noqa: E402
from repro_torch.core.selective import CostModel  # noqa: E402
from repro_torch.data.generators import power_law_temporal_graph  # noqa: E402
from repro_torch.engine import make_plan  # noqa: E402

INT_INF = np.iinfo(np.int32).max
WINDOWS = ((1.0, "full history"), (0.05, "last 5% of time"))


def run(n_vertices=2000, n_edges=60_000, seed=7, degree_cutoff=256, device=None):
    """Every result the example prints, as host values."""
    g = power_law_temporal_graph(n_vertices, n_edges, seed=seed, device=device)
    idx = build_tger(g, degree_cutoff=degree_cutoff)
    ts = g.t_start.cpu().numpy()
    t_max = int(g.t_end.max())
    out_degree = g.out_degree.cpu().numpy()
    patient_zero = int(np.argmax(out_degree))
    out = {"n_vertices": g.n_vertices, "n_edges": g.n_edges, "n_indexed": idx.n_indexed,
           "patient_zero": patient_zero, "windows": []}
    for frac, label in WINDOWS:
        lo = int(np.quantile(ts, 1 - frac))
        window = (lo, t_max)
        dec = decision_for(g, idx, window, CostModel())
        plan = make_plan(dec.method, budget=dec.budget if dec.method == "index" else 0)
        arr = earliest_arrival(g, patient_zero, window, idx, plan=plan).cpu().numpy()
        out["windows"].append((label, plan.method, float(dec.selectivity),
                               int((arr < INT_INF).sum())))
    # super-spreader ranking over the recent window
    lo = int(np.quantile(ts, 0.8))
    sources = np.argsort(out_degree)[-4:].astype(np.int32)
    bc = temporal_betweenness(g, sources, (lo, t_max), n_buckets=64).cpu().numpy()
    out["top"] = [(int(v), float(bc[v])) for v in np.argsort(bc)[-5:][::-1]]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    r = run(device=ap.parse_args(argv).device)
    print(f"contact network: {r['n_vertices']} people, {r['n_edges']} contacts, "
          f"{r['n_indexed']} hubs TGER-indexed; patient zero = {r['patient_zero']}")
    for label, method, sel, exposed in r["windows"]:
        print(f"[{label}] access={method:5s} (sel {sel:.3f})  exposed={exposed} people")
    print("top-5 temporal-betweenness hubs (recent window):")
    for v, c in r["top"]:
        print(f"  person {v:5d}  centrality {c:.1f}")
    return r


if __name__ == "__main__":
    main()
