"""Quickstart on the PyTorch port: build a temporal graph, index it, run
temporal analytics (the counterpart of ``examples/quickstart.py``, with the
same output).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

It runs on the first CUDA card unless ``--device`` names another.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import build_tger, decision_for  # noqa: E402
from repro_torch.core.algorithms import (  # noqa: E402
    earliest_arrival,
    temporal_cc,
    temporal_pagerank,
)
from repro_torch.core.temporal_graph import from_edges  # noqa: E402

INT_INF = np.iinfo(np.int32).max

# A small contact network: (who, whom, interval-start, interval-end)
#   a=0 b=1 c=2 d=3 e=4 f=5 g=6  (cf. the paper's Figure 1)
EDGES = [
    (0, 1, 1, 2), (1, 2, 3, 4), (2, 3, 5, 6),
    (0, 4, 2, 3), (4, 3, 4, 7), (3, 5, 8, 9),
    (5, 6, 10, 11), (1, 6, 2, 12),
]


def run(device=None, window=(0, 12)):
    """Every result the quickstart prints, as host values."""
    src, dst, ts, te = map(np.asarray, zip(*EDGES))
    g = from_edges(src, dst, ts, te, device=device)
    # TGER: time-first index + per-vertex histograms (selective: small cutoff
    # here so the demo actually indexes something)
    idx = build_tger(g, degree_cutoff=2)
    dec = decision_for(g, idx, window)
    return {
        "n_vertices": g.n_vertices, "n_edges": g.n_edges, "n_indexed": idx.n_indexed,
        "window": window, "method": dec.method, "selectivity": float(dec.selectivity),
        "budget": int(dec.budget),
        # earliest arrival from vertex a (Algorithm 2)
        "arrival": earliest_arrival(g, 0, window).cpu().numpy(),
        "components": temporal_cc(g, window).cpu().numpy(),
        "pagerank": temporal_pagerank(g, window, n_iters=50).cpu().numpy(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the first card)")
    r = run(ap.parse_args(argv).device)
    print(f"graph: {r['n_vertices']} vertices, {r['n_edges']} temporal edges")
    print(f"TGER built: {r['n_indexed']} vertices indexed")
    print(f"window {r['window']}: access={r['method']} "
          f"(selectivity {r['selectivity']:.2f}, budget {r['budget']})")
    for v, t in enumerate(r["arrival"]):
        label = chr(ord("a") + v)
        print(f"  earliest arrival a -> {label}: "
              f"{'unreachable' if t == INT_INF else t}")
    print("temporal components:", r["components"].tolist())
    print("top vertex by temporal PageRank:", chr(ord("a") + int(r["pagerank"].argmax())))
    return r


if __name__ == "__main__":
    main()
