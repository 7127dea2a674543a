"""The port's NequIP (``repro_torch.models.nequip``) against the JAX
package's on the same inputs: numpy-seeded atoms and the reference's
weights carried over by ``params_from_numpy``.

Tolerances (float32).  The Wigner-3j tables are the same numpy code and
equal bit for bit.  Energies within rtol 1e-5 plus 1e-6 of the largest;
forces (``torch.autograd.grad`` against ``jax.value_and_grad``) and the
energy-MSE gradients of every weight within rtol 1e-4 plus 1e-5 of the
largest entry: the segment sums and contractions add in another order.
The ``test_models.py`` NequIP cases are mirrored on the port, with the
reference's tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.data.generators import molecule_batch_graph
from repro.models import nequip as jnq
from repro_torch.models import nequip as tnq
from repro_torch.models.nequip import (
    NequIPConfig,
    init_nequip,
    nequip_energy_forces,
    nequip_forward,
    real_w3j,
)
from repro_torch.tree import tree_leaves


def _close(got, want, rel=1e-5, scale=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=scale * max(float(np.abs(want).max()), 1e-30))


def _atoms(rng, N, cutoff, n_species):
    pos = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    src, dst = np.nonzero((d < cutoff) & (d > 0))
    return {"species": rng.integers(0, n_species, N).astype(np.int32), "pos": pos,
            "src": src.astype(np.int32), "dst": dst.astype(np.int32)}


def _both(cfg_kw, seed):
    jcfg, tcfg = jnq.NequIPConfig(**cfg_kw), NequIPConfig(**cfg_kw)
    jp = jnq.init_nequip(jax.random.PRNGKey(seed), jcfg)
    tp = tnq.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def test_w3j_tables_equal_jax():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(abs(l1 - l2), l1 + l2 + 1):
                np.testing.assert_array_equal(real_w3j(l1, l2, l3), jnq.real_w3j(l1, l2, l3))
    assert NequIPConfig(name="t").paths == jnq.NequIPConfig(name="t").paths


@pytest.mark.parametrize("l_max", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_energy_and_forces_match_jax(seed, l_max):
    cfg_kw = dict(name="t", n_layers=3, d_hidden=8, l_max=l_max, n_rbf=6, cutoff=3.0,
                  n_species=5)
    jcfg, tcfg, jp, tp = _both(cfg_kw, seed)
    b = _atoms(np.random.default_rng(seed + 5), 14, 3.0, 5)
    je, jf = jnq.nequip_energy_forces(jp, {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    te, tf = nequip_energy_forces(tp, {k: torch.as_tensor(v) for k, v in b.items()}, tcfg)
    _close(te, je)
    _close(tf, jf, rel=1e-4, scale=1e-5)


def test_molecule_batch_energy_mse_grads_match_jax():
    """Per-graph energies of a molecule batch (graph ids, ``n_graphs``) and
    the energy-MSE gradient of every weight (the train cell's loss)."""
    cfg_kw = dict(name="t", n_layers=2, d_hidden=8, l_max=2, n_rbf=8, cutoff=5.0,
                  n_species=6)
    jcfg, tcfg, jp, tp = _both(cfg_kw, 3)
    rng = np.random.default_rng(4)
    src, dst, gid = molecule_batch_graph(6, 14, batch=4, seed=4)
    keep = src != dst  # a zero-length edge has no direction
    b = {"species": rng.integers(0, 6, 24).astype(np.int32),
         "pos": rng.uniform(-2, 2, (24, 3)).astype(np.float32),
         "src": src[keep].astype(np.int32), "dst": dst[keep].astype(np.int32),
         "graph_id": gid.astype(np.int32)}
    target = rng.standard_normal(4).astype(np.float32)
    jb = {**{k: jnp.asarray(v) for k, v in b.items()}, "n_graphs": 4}
    tb = {**{k: torch.as_tensor(v) for k, v in b.items()}, "n_graphs": 4}

    def jloss(p):
        return jnp.mean((jnq.nequip_forward(p, jb, jcfg) - target) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    e = nequip_forward(tp, tb, tcfg)
    _close(e, jnq.nequip_forward(jp, jb, jcfg))
    loss = torch.mean((e - torch.as_tensor(target)) ** 2)
    # the last layer's l > 0 features reach no energy: no gradient (JAX: zeros)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    _close(loss, jl)
    want = jax.tree_util.tree_leaves(jg)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        if g is None:
            assert not np.asarray(w).any()
        else:
            _close(g, w, rel=1e-4, scale=1e-5)


def test_init_draws_the_reference_layout():
    cfg_kw = dict(name="t", n_layers=2, d_hidden=16, l_max=2, n_species=8)
    jp = jnq.init_nequip(jax.random.PRNGKey(0), jnq.NequIPConfig(**cfg_kw))
    tp = init_nequip(NequIPConfig(**cfg_kw), torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, tp))
    for w, t in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        assert tuple(w.shape) == tuple(t.shape)


# ---------------------------------------------------------------------------
# test_models.py's NequIP cases, on the port
# ---------------------------------------------------------------------------

def _rot(seed):
    A = torch.randn((3, 3), generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    Q, Rm = torch.linalg.qr(A)
    Q = Q * torch.sign(torch.diag(Rm))
    if torch.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q.float()


@pytest.mark.parametrize("seed", [0, 1])
def test_nequip_e3_invariance(seed):
    cfg = NequIPConfig(name="t", n_layers=2, d_hidden=8, l_max=2, n_rbf=4,
                       cutoff=3.0, n_species=4)
    params = init_nequip(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    N = 10
    pos = torch.as_tensor(rng.uniform(-1.5, 1.5, (N, 3)), dtype=torch.float32)
    d = np.linalg.norm(pos.numpy()[:, None] - pos.numpy()[None], axis=-1)
    src, dst = np.nonzero((d < 3.0) & (d > 0))
    batch = {"species": torch.as_tensor(rng.integers(0, 4, N)), "pos": pos,
             "src": torch.as_tensor(src), "dst": torch.as_tensor(dst)}
    Q = _rot(seed + 10)
    with torch.no_grad():
        e1 = nequip_forward(params, batch, cfg)
        e2 = nequip_forward(params, {**batch, "pos": pos @ Q.T}, cfg)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-5)
    # forces rotate covariantly
    _, f1 = nequip_energy_forces(params, batch, cfg)
    _, f2 = nequip_energy_forces(params, {**batch, "pos": pos @ Q.T}, cfg)
    np.testing.assert_allclose((f1 @ Q.T).numpy(), f2.numpy(), rtol=1e-3, atol=1e-4)


def test_w3j_orthogonality():
    """The (1,1,0) intertwiner must be the (normalized) dot product."""
    c = real_w3j(1, 1, 0)[:, :, 0]
    np.testing.assert_allclose(np.abs(c), np.eye(3) / np.sqrt(3), atol=1e-6)


def test_smoke_config_is_the_reference_reduction():
    from repro.configs import get_arch as jget
    from repro_torch.configs import get_arch

    t, j = get_arch("nequip"), jget("nequip")
    want = dataclasses.replace(j.cfg, n_layers=2, d_hidden=8, n_species=4)
    got = t.smoke_cfg()
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got) if f.name != "dtype"} \
        == {f.name: getattr(want, f.name) for f in dataclasses.fields(want)
            if f.name != "dtype"}
