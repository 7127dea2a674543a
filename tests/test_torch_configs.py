"""The port's configs (``repro_torch.configs``) against the JAX package's:
every LM architecture's published and reduced config field by field,
parameter counts, model FLOPs and shape cells equal; each reduced config's
smoke step finite on the CPU (``test_configs_smoke.py``'s tests).  The
GNN, NequIP and MIND families: configs, cells and model FLOPs equal, and
their smoke runs on the reference's carried-over weights equal to the
reference's smoke within rtol 1e-5 (loss, energy: the frameworks sum in
another order).  The Kairos family is in ``test_torch_kairos.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get_arch as jget
from repro.configs import list_archs as jlist_archs
from repro.configs.families import GNN_CELLS as JGNN_CELLS
from repro.configs.families import LM_CELLS as JLM_CELLS
from repro.configs.families import RECSYS_CELLS as JRECSYS_CELLS
from repro.models import gnn as jgnn
from repro.models import mind as jmind
from repro.models import nequip as jnequip
from repro_torch.configs import (
    ASSIGNED,
    GNN_CELLS,
    LM_CELLS,
    RECSYS_CELLS,
    get_arch,
    list_archs,
)

LM_ARCHS = [a for a in ASSIGNED if get_arch(a).family == "lm"]
OTHER_ARCHS = [a for a in ASSIGNED if get_arch(a).family != "lm"]
SMOKE_TOL = dict(rtol=1e-5, atol=1e-6)

SKIP_FIELDS = {"dtype", "moe", "unroll"}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in SKIP_FIELDS}


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_configs_equal_jax(arch_id):
    j, t = jget(arch_id), get_arch(arch_id)
    assert (t.arch_id, t.family, t.source) == (j.arch_id, j.family, j.source)
    assert (t.optimizer_kind, t.opt_kw, t.microbatches, t.rules_override) == \
        (j.optimizer_kind, j.opt_kw, j.microbatches, j.rules_override)
    for tcfg, jcfg in ((t.cfg, j.cfg), (t.smoke_cfg, j.smoke_cfg)):
        assert _fields(tcfg) == {k: v for k, v in _fields(jcfg).items()
                                 if k in _fields(tcfg)}
        assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        assert (tcfg.moe is None) == (jcfg.moe is None)
        if tcfg.moe:
            assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
        assert tcfg.n_params == jcfg.n_params
        assert tcfg.n_active_params == jcfg.n_active_params
        assert tcfg.head_dim == jcfg.head_dim
    assert t.layer_count() == j.layer_count()
    for cell in LM_CELLS:
        assert t.model_flops(cell) == j.model_flops(cell)


def test_lm_cells_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in LM_CELLS.items()} == \
        {k: dataclasses.astuple(v) for k, v in JLM_CELLS.items()}


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_arch_smoke(arch_id):
    metrics = get_arch(arch_id).smoke(seed=0, device="cpu")
    finite_keys = [k for k in metrics if "finite" in k]
    assert finite_keys and all(metrics[k] for k in finite_keys), metrics
    assert torch.isfinite(torch.tensor(metrics["loss"]))
    assert metrics["decode_shape"] == (2, get_arch(arch_id).smoke_cfg.vocab)


def test_all_assigned_archs_registered():
    assert set(ASSIGNED) <= set(list_archs())
    assert ASSIGNED == JASSIGNED
    assert list_archs() == jlist_archs()
    assert "kairos" in list_archs()


@pytest.mark.parametrize("arch_id", ASSIGNED)
def test_cells_defined(arch_id):
    spec = get_arch(arch_id)
    assert len(spec.cells) == 4, f"{arch_id} must define its 4 shape cells"
    for cell in spec.cells.values():
        assert cell.kind in ("train", "prefill", "decode", "serve", "retrieval", "analytics")


def test_lm_long_500k_skip_reason():
    cell = get_arch("smollm-135m").cells["long_500k"]
    assert cell.skip and "full-attention" in cell.skip


def test_other_cells_equal_jax():
    for port, ref in ((GNN_CELLS, JGNN_CELLS), (RECSYS_CELLS, JRECSYS_CELLS)):
        assert {k: dataclasses.astuple(v) for k, v in port.items()} == \
            {k: dataclasses.astuple(v) for k, v in ref.items()}


def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


@pytest.mark.parametrize("arch_id", OTHER_ARCHS)
def test_other_configs_equal_jax(arch_id):
    """Family, source, config fields, cells and every cell's model FLOPs
    equal the reference's (FLOPs exactly)."""
    j, t = jget(arch_id), get_arch(arch_id)
    assert (t.arch_id, t.family, t.source) == (j.arch_id, j.family, j.source)
    assert sorted(t.cells) == sorted(j.cells)
    if t.family == "gnn" and hasattr(t, "arch"):
        assert (t.arch, t.n_layers, t.d_hidden, t.aggregator, t.readout_molecule) == \
            (j.arch, j.n_layers, j.d_hidden, j.aggregator, j.readout_molecule)
        for cell in t.cells:
            assert _cfg_fields(t.cfg_for(cell)) == _cfg_fields(j._cfg(j.cells[cell]))
    else:
        assert _cfg_fields(t.cfg) == _cfg_fields(j.cfg)
    if t.family == "gnn" and not hasattr(t, "arch"):
        assert t.cfg.paths == j.cfg.paths
    for cell in t.cells:
        assert t.model_flops(cell) == j.model_flops(cell)


def _reference_smoke_params(arch_id, seed):
    """The reference's smoke weights (its ``init_*`` from ``PRNGKey(seed)``)
    as numpy arrays."""
    j = jget(arch_id)
    key = jax.random.PRNGKey(seed)
    if j.family == "recsys":
        cfg = dataclasses.replace(j.cfg, n_items=500, hist_len=12, n_negatives=16)
        p = jmind.init_mind(key, cfg)
    elif hasattr(j, "arch"):
        cfg = jgnn.GNNConfig(name=j.arch_id, arch=j.arch, n_layers=min(j.n_layers, 2),
                             d_hidden=8, d_in=6, n_classes=3, aggregator=j.aggregator)
        p = jgnn.init_gnn(key, cfg)
    else:
        cfg = dataclasses.replace(j.cfg, n_layers=2, d_hidden=8, n_species=4)
        p = jnequip.init_nequip(key, cfg)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch_id", OTHER_ARCHS)
def test_other_arch_smoke(arch_id, seed):
    """``test_configs_smoke.py::test_arch_smoke`` on the port (finite, on
    the CPU), and on the reference's weights equal to the reference's smoke:
    shapes exactly, the loss (energy) within SMOKE_TOL."""
    t = get_arch(arch_id)
    metrics = t.smoke(seed=seed, device="cpu")
    finite_keys = [k for k in metrics if "finite" in k]
    assert finite_keys and all(metrics[k] for k in finite_keys), metrics
    want = jget(arch_id).smoke(seed=seed)
    got = t.smoke(seed=seed, device="cpu", params=_reference_smoke_params(arch_id, seed))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, **SMOKE_TOL)
        else:
            assert got[k] == v, k


def _params_within(tp, jp, lr):
    """Every entry within 2.5 lr of JAX's (an AdamW first step moves an
    entry by about lr x sign(g); ``test_torch_train.py``'s bound)."""
    import repro_torch.tree as ttree

    for (key, a), b in zip(ttree.tree_items(tp), jax.tree_util.tree_leaves(jp)):
        d = np.abs(a.detach().numpy().astype(np.float64) - np.asarray(b, np.float64))
        assert d.max() <= 2.5 * lr, (key, d.max() / lr)


@pytest.mark.parametrize("arch_id,cell", [("gcn-cora", "full_graph_sm"),
                                          ("gin-tu", "molecule"), ("mind", "train_batch")])
def test_train_objects_step_matches_jax(arch_id, cell):
    """Two steps of ``train_objects``' AdamW step (the one the reference's
    dry run compiles for the cell) from carried weights on seeded batches of
    the cell's shape (mind's reduced to 500 items and 8 users): losses
    within rtol 1e-5, every parameter within 2.5 lr of JAX's."""
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch.data.generators import molecule_batch_graph
    from repro_torch.models import gnn as tgnn
    from repro_torch.models import mind as tmind
    from repro_torch.train.train_step import TrainConfig, init_train_state

    j, t = jget(arch_id), get_arch(arch_id)
    rng = np.random.default_rng(5)
    if arch_id == "mind":
        jcfg = dataclasses.replace(j.cfg, n_items=500, hist_len=12, n_negatives=16)
        tcfg = dataclasses.replace(t.cfg, n_items=500, hist_len=12, n_negatives=16)
        jp = jmind.init_mind(jax.random.PRNGKey(0), jcfg)
        tp = tmind.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
        jloss = lambda p, b: (jmind.train_loss(p, b, jcfg), {})
        topt, tstep = t.train_objects(tcfg)
        batches = [{"hist": rng.integers(0, 500, (8, 12)), "target": rng.integers(1, 500, 8),
                    "negatives": rng.integers(1, 500, (8, 16))} for _ in range(2)]
    else:
        m = t.cells[cell].meta
        jcfg, tcfg = j._cfg(j.cells[cell]), t.cfg_for(cell)
        jp = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
        tp = tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
        n_graphs = m.get("batch") if cell == "molecule" else None
        jloss = lambda p, b: (jgnn.gnn_loss(
            p, {**b, "n_graphs": n_graphs} if n_graphs else b, jcfg), {})
        topt, tstep = t.train_objects(cell)
        batches = []
        for _ in range(2):
            if cell == "molecule":
                s, d, gid = molecule_batch_graph(m["n_nodes"], m["n_edges"], m["batch"],
                                                 seed=int(rng.integers(100)))
                n = m["n_nodes"] * m["batch"]
                b = dict(src=s, dst=d, graph_id=gid,
                         labels=rng.integers(0, m["n_classes"], m["batch"]))
            else:
                n = m["n_nodes"]
                b = dict(src=rng.integers(0, n, m["n_edges"]),
                         dst=rng.integers(0, n, m["n_edges"]),
                         labels=rng.integers(0, m["n_classes"], n))
            b["x"] = rng.standard_normal((n, m["d_feat"])).astype(np.float32)
            batches.append(b)
    jo = jopt.make_optimizer("adamw", 1e-3)
    jstep = jax.jit(jts.make_train_step(jloss, jo, jts.TrainConfig()))
    jst = jts.init_train_state(jp, jo, jts.TrainConfig())
    tst = init_train_state(tp, topt, TrainConfig())
    for b in batches:
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        tp, tst, tm = tstep(tp, tst, {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        _params_within(tp, jp, 1e-3)
