"""Every cell run end to end at a tiny size on the CPU: traffic drawn from
the seed, the check against the reference, its control, the faults it has
to catch, and a cell, configuration, traffic mix and metric added as new
files only."""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from portbench import bench, plugins
from portbench.tests.conftest import CELLS, REPO, SEED, make_tiny_root



def run(root, cell, seed=SEED, **kw):
    return bench.run_cell(root, cell, seed, kw.pop("seconds", 0.6), kw.pop("trace", False),
                          device="cpu", **kw)


def _limits_failed(root, cell, numbers):
    limits = plugins.load_cell(root, cell).workload["limits"]
    return [n for n, lim in limits.items() if numbers[n] > lim]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_reports_its_metrics(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    spec = plugins.load_cell(tiny_root, cell)
    assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert list(res)[-1] == "checks"
    assert res["setup_parts_s"]["kernel_build"] >= 0.0


def test_kernel_build_is_timed_apart(monkeypatch):
    """Set-up reports the time spent building the port's kernels apart."""
    import time

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "compile_source", lambda stem: time.sleep(0.05) or stem)
    fake = build.compile_source
    parts = {}
    with bench.kernel_build_timed(parts):
        assert build.compile_source("segment_spmm") == "segment_spmm"
    assert parts["kernel_build"] >= 0.05
    assert build.compile_source is fake      # the program's own function again


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(tiny_root, cell):
    res = run(tiny_root, cell, trace=True, seconds=0.8)
    assert res["correct"]
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    spec = plugins.load_cell(tiny_root, cell)
    names = {m["name"] for m in spec.per_layer}
    assert "setup.graph_build_s" in res["metrics"]
    # the device metrics need a card: on the CPU only the host-side ones appear
    assert set(res["metrics"]) <= names


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_deterministic_per_seed(tiny_root, cell):
    spec = plugins.load_cell(tiny_root, cell)
    builder = plugins.load_module(tiny_root, "graphs", spec.config["builder"])
    entry = plugins.load_module(tiny_root, "entries", spec.traffic["entry"])

    def draw(seed):
        inputs = builder.generate(spec.config, seed, "cpu")
        req = entry.draw(spec.traffic, spec.config, inputs, seed, "cpu")
        return json.dumps([repr(x.tolist() if hasattr(x, "tolist") else
                                [y.tolist() for y in x] if isinstance(x, list) else x)
                           for x in req])

    assert draw(SEED) == draw(SEED)
    assert draw(SEED) != draw(SEED + 1)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    """The reference in the configuration's lower precision, put in the
    program's place, fails at least one of the cell's limits."""
    res = run(tiny_root, cell, control="lowp")
    assert res["correct"]
    assert _limits_failed(tiny_root, cell, res["control"]), res["control"]


def _stuck_runner(monkeypatch):
    """A fixpoint step that returns its state unchanged."""
    from repro_torch.distributed import graph_engine as ge
    from repro_torch.engine import fixpoint

    monkeypatch.setattr(fixpoint.FixpointRunner, "run",
                        lambda self, cond, body, init, with_rounds=False:
                        (init, 1) if with_rounds else init)
    monkeypatch.setattr(ge, "make_ea_round_plan",
                        lambda *a, **k: (lambda arrival, *rest: arrival))
    monkeypatch.setattr(ge, "make_pagerank_round", lambda *a, **k: (lambda pr, *rest: pr))


def _half_the_batch(monkeypatch):
    """Half of each batch left out: the rows (or edges) past the middle
    are never relaxed."""
    from repro_torch.distributed import graph_engine as ge
    from repro_torch.engine import fixpoint

    real_init = fixpoint.FixpointRunner.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        if self.batched:
            self.valid = self.valid.clone()
            self.valid[self.valid.shape[0] // 2:] = False
    monkeypatch.setattr(fixpoint.FixpointRunner, "__init__", init)
    real_ea = ge.run_distributed_ea

    def half_ea(mesh, arrival0, *a, **k):
        out, rounds = real_ea(mesh, arrival0, *a, **k)
        half = out.shape[0] // 2
        out[half:] = arrival0[half:]
        return out, rounds
    monkeypatch.setattr(ge, "run_distributed_ea", half_ea)
    real_pr = ge.make_pagerank_round

    def half_pr(mesh, n, **k):
        rnd = real_pr(mesh, n, **k)

        def r(pr, src, dst, ts, te, valid, inv, window):
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = False
            return rnd(pr, src, dst, ts, te, valid, inv, window)
        return r
    monkeypatch.setattr(ge, "make_pagerank_round", half_pr)


def _altered_answer(monkeypatch, root, cell):
    """One answer altered where it is produced: the entry's first output
    entry that the request returns is changed."""
    entry = plugins.load_module(root, "entries",
                                plugins.load_cell(root, cell).traffic["entry"])
    real = entry.Driver.request

    def request(self, i):
        out, counts = real(self, i)
        t = out[1]
        if isinstance(t, tuple):           # serving: the first group's rows
            t = t[0]
            t = t[1] if isinstance(t, tuple) else t
        if t.is_floating_point():
            t.view(-1)[0] *= 1.01
        else:
            t.view(-1)[0] = 7
        return out, counts
    monkeypatch.setattr(entry.Driver, "request", request)
    return entry


@pytest.mark.parametrize("fault", ["stuck", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_make_the_run_incorrect(tmp_path, monkeypatch, cell, fault):
    root = make_tiny_root(tmp_path)
    if fault == "stuck":
        _stuck_runner(monkeypatch)
    elif fault == "half":
        _half_the_batch(monkeypatch)
    else:
        entry = _altered_answer(monkeypatch, root, cell)
        monkeypatch.setattr(plugins, "load_module",
                            _returning(plugins.load_module, entry, "entries"))
    res = run(root, cell, samples=64)
    assert not res["correct"], res["checks"]


def _returning(load, module, kind):
    def load_module(root, k, name):
        return module if k == kind else load(root, k, name)
    return load_module


def test_new_cell_config_traffic_and_metric_are_files_only(tmp_path):
    """A later PR's additions: a configuration file, a traffic mix, a
    cell's limits and a metric reader, and entries in BENCHMARK.json."""
    root = make_tiny_root(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs/kairos-synth-1e9.json").read_text())
    cfg.update(name="kairos-synth-small", vertices=150, edges=200000)
    (pb / "configs/kairos-synth-small.json").write_text(json.dumps(cfg))
    (pb / "traffic/ea8_wide.json").write_text(json.dumps(
        {"entry": "ea_distributed", "access": "index", "budget": 60000,
         "window_edges_inside": 5000, "sources": 8, "queries": 4, "max_rounds": 1000,
         "warm_queries": 1, "check_sample": 2}))
    (pb / "workloads/small.ea8.json").write_text(json.dumps({"limits": {"ea_mismatch": 0}}))
    (pb / "metrics/query_p50_ms.py").write_text(
        "from portbench.stats import percentile\n\n\n"
        "def read(run):\n    return 1e3 * percentile(run.latencies_s, 50)\n")
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    bench_json["configs"].append({"name": "kairos-synth-small", "source": "x",
                                  "file": "portbench/configs/kairos-synth-small.json",
                                  "reduced": ["vertices", "edges"], "why": "test"})
    bench_json["workloads"].append({"name": "small.ea8", "config": "kairos-synth-small",
                                    "traffic": "ea8_wide", "chips": 1, "why": "test"})
    bench_json["end_to_end"].append({"name": "query_p50_ms", "unit": "ms", "better": "lower",
                                     "bound": 0.05, "source": "host_clock",
                                     "workloads": ["small.ea8"]})
    for m in bench_json["end_to_end"]:
        if m["name"] in ("query_rate", "query_p95_ms"):
            m["workloads"].append("small.ea8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    res = run(root, "small.ea8")
    assert res["correct"]
    assert set(res["metrics"]) == {"query_rate", "query_p95_ms", "query_p50_ms", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before       # nothing that was there changed


def test_no_jax_in_a_run(tmp_path):
    """A run loads neither JAX nor the JAX package (``repro``) beside the
    port (``repro_torch``), compared by whole top-level names."""
    from portbench import guard

    assert guard.forbidden_loaded(["repro_torch", "repro_torch.serve", "jaxtyping",
                                   "numpy"]) == []
    assert guard.forbidden_loaded(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro.core"]
    root = make_tiny_root(tmp_path)
    code = ("import sys; sys.path[0:0] = [%r, %r]\n"
            "from portbench.bench import run_cell\n"
            "res = run_cell(__import__('pathlib').Path(%r), 'kairos1e9.pagerank', 5, 0.3, False,"
            " device='cpu')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'flax', 'repro'))\n"
            "assert res['correct'] and not bad, bad\n" % (str(REPO), str(REPO / "src"),
                                                           str(root)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_cli_needs_a_card_and_prints_no_result(tmp_path):
    """Without a CUDA card (and in a directory holding only BENCHMARK.json
    and the benchmark's files) the command fails and prints no result."""
    root = make_tiny_root(tmp_path)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kairos1e9.pagerank",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_selective_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = make_tiny_root(Path(tempfile.mkdtemp(prefix="portbench-cuda-test-")))
    res = bench.run_cell(root, "kairos1e9.ea_selective", SEED, 1.0, True)
    assert res["correct"] and res["device"]["busy_s"] > 0
