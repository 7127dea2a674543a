"""The port's boundaries: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_arch
from repro_torch.core.temporal_graph import from_edges
from repro_torch.data import generators as tgen
from repro_torch.device import resolve_device
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn import init_gnn
from repro_torch.models.transformer import init_cache, init_lm, params_from_numpy

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.algorithms, repro_torch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.kernels.segment_spmm, repro_torch.kernels.ref\n"
        "import repro_torch.data, repro_torch.engine.fixpoint\n"
        "import repro_torch.core.algorithms.pagerank, repro_torch.core.algorithms.bfs\n"
        "import repro_torch.core.algorithms.connectivity\n"
        "import repro_torch.core.algorithms.kcore\n"
        "import repro_torch.core.algorithms.reachability\n"
        "import repro_torch.core.algorithms.centrality\n"
        "import repro_torch.core.onepass, repro_torch.engine.queries\n"
        "import repro_torch.configs, repro_torch.models.transformer\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.models.moe, repro_torch.tree, repro_torch.data.tokens\n"
        "import repro_torch.train.optimizer, repro_torch.train.train_step\n"
        "import repro_torch.train.checkpoint, repro_torch.train.elastic\n"
        "import repro_torch.distributed.compression, repro_torch.distributed.sharding\n"
        "import repro_torch.configs.families, repro_torch.launch.train\n"
        "import repro_torch.configs.kairos, repro_torch.core.selective\n"
        "import repro_torch.core.predicates, repro_torch.engine.backends\n"
        "import repro_torch.models.gnn, repro_torch.models.nequip\n"
        "import repro_torch.models.mind, repro_torch.models.params\n"
        "import repro_torch.data.samplers, repro_torch.distributed\n"
        "from repro_torch.engine import FixpointRunner, get_backend, XlaSegmentBackend\n"
        "from repro_torch.configs import ASSIGNED, get_arch\n"
        "assert all(get_arch(a) for a in ASSIGNED + ['kairos'])\n"
        "from repro_torch.kernels import launch_counts\n"
        "assert set(launch_counts()) == {'segment_min_tiles',\n"
        "    'temporal_relax_min_tiles', 'segment_spmm_tiles', 'decode_attention'}\n"
        "import contextlib, io, tempfile\n"
        "from repro_torch.launch import dryrun\n"
        "with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert dryrun.main(['--arch', 'kairos', '--shape', 'cc_1b', '--out', tmp]) == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("entry", [
    lambda: from_edges([0, 1], [1, 2], [0, 5]),
    lambda: tgen.power_law_temporal_graph(20, 50),
    lambda: tgen.transit_temporal_graph(20, 50),
    lambda: tgen.synthetic_temporal_graph(20, 50),
    lambda: resolve_device(),
    lambda: repro_torch.frontier_from_sources(5, [1, 3]),
    lambda: init_cache(get_arch("smollm-135m").smoke_cfg, 1, 8),
    lambda: init_lm(get_arch("smollm-135m").smoke_cfg, torch.Generator()),
    lambda: params_from_numpy({}, get_arch("smollm-135m").smoke_cfg),
    lambda: launch_serve.main(["--requests", "1", "--max-new", "1"]),
    lambda: launch_serve.main(["--graph", "--advances", "1"]),
    lambda: launch_serve.main(["--graph", "--daemon", "--ticks", "1",
                               "--history-chunks", "64"]),
    lambda: launch_train.main(["--scale", "smoke", "--steps", "1"]),
    lambda: get_arch("qwen3-moe-30b-a3b").smoke(),
    lambda: get_arch("kairos").smoke(),
    lambda: get_arch("gcn-cora").smoke(),
    lambda: get_arch("nequip").smoke(),
    lambda: get_arch("mind").smoke(),
    lambda: init_gnn(get_arch("gin-tu").smoke_cfg(), torch.Generator()),
    lambda: params_from_numpy({}, get_arch("smollm-135m").smoke_cfg),
])
def test_entry_points_need_a_card_or_an_explicit_device(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_init_lm_needs_the_generator_on_its_device():
    """A CPU generator does not quietly build the model on the CPU: the
    weights go to the named device, and a generator elsewhere raises."""
    cfg = get_arch("smollm-135m").smoke_cfg
    with pytest.raises(ValueError, match="generator"):
        init_lm(cfg, torch.Generator(), device="cuda")
    model = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert model.device == torch.device("cpu")


def test_explicit_cpu_device_and_downstream_follows():
    g = from_edges(np.array([0, 1]), np.array([1, 2]), np.array([0, 5]),
                   np.array([1, 6]), device="cpu")
    assert g.device == torch.device("cpu")
    idx = repro_torch.build_tger(g, degree_cutoff=1)
    plan = repro_torch.plan_query(g, idx, (0, 10), backend="pallas_tiled")
    assert idx.perm_by_start.device == g.device
    assert plan.layout_perm.device == g.device
    assert resolve_device("cpu") == torch.device("cpu")
    f = repro_torch.frontier_from_sources(3, [1], device="cpu")
    assert f.device == torch.device("cpu") and f.tolist() == [False, True, False]


# names of the JAX package's packages that are JAX mechanisms, left out of
# the port on purpose (none today: every public name has a counterpart)
JAX_ONLY = {"repro.core": set(), "repro.engine": set(), "repro.distributed": set()}


def _public(module):
    """``__all__`` where the package defines it, else its public names that
    are not submodules."""
    import types

    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


@pytest.mark.parametrize("package", sorted(JAX_ONLY))
def test_package_exports_cover_the_references(package):
    """Every name ``repro.core``, ``repro.engine`` and ``repro.distributed``
    export is exported by the port's package of the same name (less the
    JAX-only names, by name); where both define ``__all__`` the lists are
    equal."""
    import importlib

    importlib.import_module("repro.core")  # the JAX package imports core before engine
    ref = importlib.import_module(package)
    port = importlib.import_module(package.replace("repro", "repro_torch", 1))
    missing = _public(ref) - _public(port) - JAX_ONLY[package]
    assert not missing, sorted(missing)
    if hasattr(ref, "__all__"):
        assert sorted(port.__all__) == sorted(ref.__all__)
