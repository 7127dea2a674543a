"""The port's GNNs (``repro_torch.models.gnn``: GCN, GIN, GraphSAGE)
against the JAX package's on the same inputs: numpy-seeded graphs and the
reference's weights carried over by ``params_from_numpy``.

Tolerances (float32).  Forward logits and the loss within rtol 1e-5 plus
1e-6 of the largest logit: the segment sums add in another order, and
GCN's float32 ``rsqrt`` of the degree may differ from XLA's by an ulp.
Gradients within rtol 1e-4 plus 1e-5 of the leaf's largest gradient.
The ``test_models.py`` GNN cases are mirrored on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.models import gnn as jgnn
from repro_torch.models import gnn as tgnn
from repro_torch.models.gnn import GNNConfig, gnn_forward, init_gnn
from repro_torch.tree import tree_leaves

ARCHS = [("gcn", "mean"), ("gin", "sum"), ("graphsage", "mean"), ("graphsage", "sum")]


def _close(got, want, rel=1e-5, scale=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=scale * max(float(np.abs(want).max()), 1e-30))


def _batch(rng, N, E, d_in, n_classes, readout=None, n_graphs=4, mask=False):
    b = {"x": rng.standard_normal((N, d_in)).astype(np.float32),
         "src": rng.integers(0, N, E).astype(np.int32),
         "dst": rng.integers(0, N, E).astype(np.int32)}
    if readout:
        b["graph_id"] = np.repeat(np.arange(n_graphs), N // n_graphs).astype(np.int32)
        b["labels"] = rng.integers(0, n_classes, n_graphs).astype(np.int32)
    else:
        b["labels"] = rng.integers(0, n_classes, N).astype(np.int32)
    if mask:
        b["label_mask"] = (rng.random(N) < 0.3).astype(np.float32)
    return b


def _both(cfg_kw, seed):
    jcfg, tcfg = jgnn.GNNConfig(**cfg_kw), GNNConfig(**cfg_kw)
    jp = jgnn.init_gnn(jax.random.PRNGKey(seed), jcfg)
    tp = tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("readout", [None, "sum", "mean"])
@pytest.mark.parametrize("arch,agg", ARCHS)
def test_forward_loss_grads_match_jax(arch, agg, readout):
    """Logits, the loss (node labels, a label mask, or pooled graph labels)
    and the gradient of every weight against ``jax.grad``."""
    cfg_kw = dict(name="t", arch=arch, n_layers=3, d_hidden=12, d_in=7, n_classes=5,
                  aggregator=agg, readout=readout)
    jcfg, tcfg, jp, tp = _both(cfg_kw, seed=len(arch))
    rng = np.random.default_rng(3)
    b = _batch(rng, 48, 200, 7, 5, readout=readout, mask=readout is None)
    if readout:
        b["n_graphs"] = 4
    jb = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
    tb = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
    _close(gnn_forward(tp, tb, tcfg), jgnn.gnn_forward(jp, jb, jcfg))
    jloss, jgrads = jax.value_and_grad(jgnn.gnn_loss)(jp, jb, jcfg)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tgnn.gnn_loss(tp, tb, tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    _close(loss, jloss)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        _close(torch.zeros(w.shape) if g is None else g, w, rel=1e-4, scale=1e-5)


def test_readout_without_n_graphs_reads_graph_ids():
    """Without ``n_graphs`` the readout counts the graphs from the ids, as
    the reference does."""
    cfg_kw = dict(name="t", arch="gin", n_layers=2, d_hidden=8, d_in=5, n_classes=3,
                  aggregator="sum", readout="sum")
    jcfg, tcfg, jp, tp = _both(cfg_kw, seed=0)
    b = _batch(np.random.default_rng(1), 40, 120, 5, 3, readout="sum", n_graphs=5)
    out = gnn_forward(tp, {k: torch.as_tensor(v) for k, v in b.items()}, tcfg)
    assert out.shape == (5, 3)
    _close(out, jgnn.gnn_forward(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg))


def test_init_draws_the_reference_layout():
    """``init_gnn`` draws the reference's tree: the same structure, shapes
    and dtypes; biases and GIN's eps zero; weights ~ N(0, 1/fan_in)."""
    for arch, agg in ARCHS:
        kw = dict(name="t", arch=arch, n_layers=3, d_hidden=64, d_in=32, n_classes=4,
                  aggregator=agg)
        jp = jgnn.init_gnn(jax.random.PRNGKey(0), jgnn.GNNConfig(**kw))
        tp = init_gnn(GNNConfig(**kw), torch.Generator().manual_seed(0), "cpu")
        assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, tp))
        for w, t in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
            assert tuple(w.shape) == tuple(t.shape) and t.dtype == torch.float32
            if w.ndim == 2:
                assert abs(float(t.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.15
            else:
                assert not t.any()
    with pytest.raises(ValueError, match="generator"):
        init_gnn(GNNConfig(**kw), torch.Generator(), "meta")
    with pytest.raises(ValueError, match="shape"):
        tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               GNNConfig(**dict(kw, d_in=31)), "cpu")


# ---------------------------------------------------------------------------
# test_models.py's GNN cases, on the port
# ---------------------------------------------------------------------------

def test_gnn_permutation_equivariance():
    """Relabeling nodes permutes outputs identically (sum aggregation)."""
    cfg = GNNConfig(name="t", arch="gin", n_layers=2, d_hidden=8, d_in=5,
                    n_classes=3, aggregator="sum")
    params = init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    N, E = 12, 40
    x = rng.standard_normal((N, 5)).astype(np.float32)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    out1 = gnn_forward(params, {"x": torch.as_tensor(x), "src": torch.as_tensor(src),
                                "dst": torch.as_tensor(dst)}, cfg)
    perm = rng.permutation(N)
    inv = np.argsort(perm)
    out2 = gnn_forward(params, {"x": torch.as_tensor(x[perm]),
                                "src": torch.as_tensor(inv[src]),
                                "dst": torch.as_tensor(inv[dst])}, cfg)
    # node v lands at position inv[v] after relabeling: out2[inv[v]] == out1[v]
    np.testing.assert_allclose(out2.detach().numpy()[inv], out1.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_gcn_isolated_vertices_keep_self_signal():
    cfg = GNNConfig(name="t", arch="gcn", n_layers=1, d_hidden=4, d_in=3, n_classes=2)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.ones((5, 3))
    out = gnn_forward(params, {"x": x, "src": torch.tensor([0]), "dst": torch.tensor([1])},
                      cfg)
    assert bool(torch.isfinite(out).all())
    assert not bool((out[4] == 0).all())  # isolated node: self loop only
