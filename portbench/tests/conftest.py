"""The benchmark's CPU tests: every cell at a tiny size, on the CPU.

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json`` and
``portbench/``) whose configurations and traffic mixes are cut to a size a
test can hold; the harness runs there with ``device="cpu"``, which skips
its look for a card."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "configs/kairos-synth-1e7.json": dict(vertices=2000, edges=40000, degree_cutoff=64),
    # few vertices, many edges: hubs whose sums a float32 accumulator rounds;
    # gaps of 100 put the times past 2**24, where float32 drops their low bits
    "configs/kairos-synth-1e9.json": dict(vertices=200, edges=400000,
                                          assumed={"poisson_gap": 100.0}),
    "traffic/ea128_selective.json": dict(sources=4, queries=8, budget=40000,
                                         window_edges_inside=2000),
    "traffic/pagerank_asof.json": dict(queries=4),
}
CELLS = ("kairos1e7.serve", "kairos1e9.ea_selective", "kairos1e9.pagerank")
SEED = 2**31 + 12345


def make_tiny_root(dst: Path) -> Path:
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for rel, upd in TINY.items():
        path = dst / "portbench" / rel
        d = json.loads(path.read_text())
        d.update(upd)
        path.write_text(json.dumps(d))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import torch

    torch.set_num_threads(2)
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
