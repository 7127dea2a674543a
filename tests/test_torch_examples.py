"""The port's examples (``examples/*_torch.py``) against the JAX package's
(``examples/*.py``): the quickstart and the distributed example print what
the JAX examples print; the other three examples' ``run`` at small sizes
equals the same calls on the JAX package.  Integers are held bit for bit,
betweenness within rtol 1e-5 (``test_torch_betweenness.py``'s tolerance),
losses within rtol 1e-5 (``test_torch_train.py``'s)."""
import importlib.util
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.core import build_tger as jbuild_tger
from repro.core import decision_for as jdecision_for
from repro.core.algorithms import earliest_arrival as jearliest_arrival
from repro.core.algorithms import temporal_betweenness as jbetweenness
from repro.core.selective import CostModel as JCostModel
from repro.data.generators import power_law_temporal_graph as jpower_law
from repro.engine import make_plan as jmake_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
PORTED = ("quickstart", "contact_tracing", "distributed_analytics", "serve_lm", "train_lm")
INT_INF = np.iinfo(np.int32).max


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_import_neither_jax_nor_the_jax_package():
    code = (
        "import runpy, sys\n"
        f"for name in {[f'{n}_torch' for n in PORTED]!r}:\n"
        f"    runpy.run_path({EXAMPLES!r} + '/' + name + '.py', run_name='imported')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_quickstart_prints_what_the_jax_example_prints(capsys):
    _load("quickstart").main()
    want = capsys.readouterr().out
    _load("quickstart_torch").main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert "earliest arrival a -> g: 11" in want


def _jax_contact_tracing(n_vertices, n_edges, seed, degree_cutoff):
    """The reference example's body at other sizes, returning its numbers."""
    g = jpower_law(n_vertices, n_edges, seed=seed)
    idx = jbuild_tger(g, degree_cutoff=degree_cutoff)
    ts = np.asarray(g.t_start)
    t_max = int(np.asarray(g.t_end).max())
    patient_zero = int(np.argmax(np.asarray(g.out_degree)))
    out = {"n_indexed": idx.n_indexed, "patient_zero": patient_zero, "windows": []}
    for frac, label in ((1.0, "full history"), (0.05, "last 5% of time")):
        window = (int(np.quantile(ts, 1 - frac)), t_max)
        dec = jdecision_for(g, idx, window, JCostModel())
        plan = jmake_plan(dec.method, budget=dec.budget if dec.method == "index" else 0)
        arr = np.asarray(jearliest_arrival(g, patient_zero, window, idx, plan=plan))
        out["windows"].append((label, plan.method, float(dec.selectivity),
                               int((arr < INT_INF).sum())))
    lo = int(np.quantile(ts, 0.8))
    sources = np.argsort(np.asarray(g.out_degree))[-4:].astype(np.int32)
    out["bc"] = np.asarray(jbetweenness(g, sources, (lo, t_max), n_buckets=64))
    return out


def test_contact_tracing_run_equals_jax():
    sizes = dict(n_vertices=400, n_edges=12_000, seed=7, degree_cutoff=64)
    got = _load("contact_tracing_torch").run(**sizes, device="cpu")
    want = _jax_contact_tracing(**sizes)
    assert (got["n_vertices"], got["n_edges"]) == (400, 12_000)
    assert got["n_indexed"] == want["n_indexed"] > 0
    assert got["patient_zero"] == want["patient_zero"]
    assert [w[:2] + w[3:] for w in got["windows"]] == [w[:2] + w[3:] for w in want["windows"]]
    for (_, _, s1, _), (_, _, s2, _) in zip(got["windows"], want["windows"]):
        assert s1 == pytest.approx(s2, rel=1e-6)
    # the decision flips between the full history and the recent window
    assert {w[1] for w in got["windows"]} == {"scan", "index"}
    for v, c in got["top"]:
        assert c == pytest.approx(float(want["bc"][v]), rel=1e-5)
    assert sorted(c for _, c in got["top"]) == pytest.approx(
        sorted(np.sort(want["bc"])[-5:]), rel=1e-5)


def test_distributed_analytics_on_8_gloo_ranks_equals_jax():
    """The example's ``run`` on 8 spawned gloo ranks of a (4, 2) mesh: both
    distributed paths equal the JAX package's single-device EA."""
    mod = _load("distributed_analytics_torch")
    sys.path.insert(0, EXAMPLES)
    try:
        dist_mod = importlib.import_module("distributed_analytics_torch")
        res = dist_mod.spawn_cpu(8, n_vertices=150, n_edges=4000)
    finally:
        sys.path.remove(EXAMPLES)
    assert res["mesh"] == {"data": 4, "model": 2} and mod.mesh_shape(8) == (4, 2)
    g = jpower_law(150, 4000, seed=11)
    want = np.stack([np.asarray(jearliest_arrival(g, s, res["window"]))
                     for s in mod.SOURCES])
    assert np.array_equal(res["scan"], want) and np.array_equal(res["selective"], want)
    assert res["scan_equal"] and res["selective_equal"]
    assert res["reach"] == int((want[0] < INT_INF).sum()) > 1


def test_distributed_analytics_cli_prints_what_the_jax_example_prints():
    """Both examples as their users run them: the JAX one on 8 forced host
    devices, the port's with ``--device cpu`` (8 spawned gloo ranks)."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    outs = []
    for argv in (["examples/distributed_analytics.py"],
                 ["examples/distributed_analytics_torch.py", "--device", "cpu"]):
        out = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                             timeout=300, cwd=ROOT, env=env, check=False)
        assert out.returncode == 0, out.stderr[-3000:]
        outs.append(out.stdout)
    assert outs[1] == outs[0]
    assert "scan path == single-device: True" in outs[0]


def _engine_line(text):
    m = re.search(r"completed (\d+)/(\d+) requests, (\d+) tokens in (\d+) engine steps", text)
    return tuple(int(x) for x in m.groups())


def test_serve_lm_run_equals_jax(capsys, monkeypatch):
    from repro.launch import serve as jserve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "smollm-135m", "--requests", "5",
                                      "--slots", "2", "--max-new", "4"])
    jserve.main()
    want = _engine_line(capsys.readouterr().out)
    stats = _load("serve_lm_torch").run(requests=5, slots=2, max_new=4, device="cpu")
    got = _engine_line(capsys.readouterr().out)
    assert got == want == (stats.requests_completed, 5, stats.tokens_generated, stats.steps)


def test_train_lm_run_equals_jax(tmp_path, monkeypatch):
    """Three trainer steps from the reference's weights (``init_params(
    PRNGKey(0))`` carried over for the port's ``init_lm``) on the same
    corpus and schedule: the same losses."""
    from repro.launch import train as jtrain
    from repro.models import transformer as jtf
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as ttf

    argv = ["--arch", "smollm-135m", "--scale", "smoke", "--steps", "3", "--batch", "4",
            "--seq", "32", "--lr", "3e-3", "--ckpt", str(tmp_path / "jax"),
            "--ckpt-every", "100"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    want = jtrain.main()

    def carried(cfg, generator, device=None):
        params = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
        return ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg, device)

    from repro.configs import get_arch as jget

    cfg_j = jget("smollm-135m").smoke_cfg
    monkeypatch.setattr(ttrain.tf, "init_lm", carried)
    got = _load("train_lm_torch").run(steps=3, device="cpu", ckpt=str(tmp_path / "port"),
                                      batch=4, seq=32)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
