"""The port's MIND (``repro_torch.models.mind``) against the JAX package's
on the same inputs: numpy-seeded histories and the reference's weights
carried over by ``params_from_numpy``.

Tolerances (float32).  Interests, scores and the loss within rtol 1e-5
plus 1e-6 of the largest entry; the gradients of every weight within rtol
1e-4 plus 1e-5 of the leaf's largest gradient (the contractions add in
another order).  Retrieval ids (positions in the candidate list) equal
JAX's ``top_k`` bit for bit, on distinct and on tied scores (repeated
candidates score the same).  The ``test_models.py`` MIND cases are
mirrored on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.models import mind as jmind
from repro_torch.models import mind as tmind
from repro_torch.models.mind import (
    MINDConfig,
    embedding_bag,
    init_mind,
    score_candidates,
    user_tower,
)
from repro_torch.tree import tree_leaves


def _close(got, want, rel=1e-5, scale=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=scale * max(float(np.abs(want).max()), 1e-30))


def _both(seed, **kw):
    cfg_kw = dict(name="t", n_items=300, hist_len=10, n_interests=3, n_negatives=20, **kw)
    jcfg, tcfg = jmind.MINDConfig(**cfg_kw), MINDConfig(**cfg_kw)
    jp = jmind.init_mind(jax.random.PRNGKey(seed), jcfg)
    tp = tmind.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _hist(rng, B, H, n_items):
    hist = rng.integers(1, n_items, (B, H)).astype(np.int32)
    hist[:, H - rng.integers(0, H // 2, B)[0]:] = 0  # padded tails
    hist[0, 3:] = 0
    return hist


@pytest.mark.parametrize("seed", [0, 1])
def test_user_tower_and_loss_grads_match_jax(seed):
    jcfg, tcfg, jp, tp = _both(seed)
    rng = np.random.default_rng(seed + 2)
    B = 6
    b = {"hist": _hist(rng, B, 10, 300),
         "target": rng.integers(1, 300, B).astype(np.int32),
         "negatives": rng.integers(1, 300, (B, 20)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    with torch.no_grad():
        _close(user_tower(tp, tb["hist"], tcfg), jmind.user_tower(jp, jb["hist"], jcfg))
        _close(tmind.serve_step(tp, tb, tcfg), jmind.serve_step(jp, jb, jcfg))
    jl, jg = jax.value_and_grad(jmind.train_loss)(jp, jb, jcfg)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tmind.train_loss(tp, tb, tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    _close(loss, jl)
    want = jax.tree_util.tree_leaves(jg)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        if g is None:  # the fixed routing initializer: JAX's gradient is zero too
            assert not np.asarray(w).any()
        else:
            _close(g, w, rel=1e-4, scale=1e-5)


@pytest.mark.parametrize("ties", [False, True])
def test_retrieval_ids_match_jax(ties):
    """Top-100 of 400 candidates for 3 users: scores within tolerance, ids
    bit for bit.  With ties, every candidate item appears 4 times, so each
    score is tied four ways and only the tie-break orders them."""
    jcfg, tcfg, jp, tp = _both(5)
    rng = np.random.default_rng(9)
    hist = _hist(rng, 3, 10, 300)
    if ties:
        cands = np.repeat(rng.integers(1, 300, 100), 4).astype(np.int32)
        rng.shuffle(cands)
    else:
        cands = rng.permutation(300)[:250].astype(np.int32)
    jb = {"hist": jnp.asarray(hist), "candidates": jnp.asarray(cands)}
    tb = {"hist": torch.as_tensor(hist), "candidates": torch.as_tensor(cands)}
    jv, ji = jmind.retrieval_step(jp, jb, jcfg, top_k=100)
    with torch.no_grad():
        tv, ti = tmind.retrieval_step(tp, tb, tcfg, top_k=100)
        scores = score_candidates(tp, user_tower(tp, tb["hist"], tcfg), tb["candidates"])
    _close(tv, jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if ties:
        # equal scores at different positions: the lower position first
        s = scores.numpy()
        for row in range(3):
            picked = ti[row].numpy()
            for a, b2 in zip(picked[:-1], picked[1:]):
                if s[row, a] == s[row, b2]:
                    assert a < b2


def test_stable_top_k_breaks_ties_as_jax():
    """Exact ties, including whole rows of one value: JAX's order."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 5, (6, 64)).astype(np.float32)
    scores[0] = 1.5
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 10)
    tv, ti = tmind.stable_top_k(torch.as_tensor(scores), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_init_draws_the_reference_layout():
    cfg_kw = dict(name="t", n_items=1000, hist_len=8, n_interests=3)
    jp = jmind.init_mind(jax.random.PRNGKey(0), jmind.MINDConfig(**cfg_kw))
    tp = init_mind(MINDConfig(**cfg_kw), torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
        assert tp[k].dtype == torch.float32
    assert abs(float(tp["item_embed"].std()) - 0.02) < 0.002
    assert not tp["mlp_b1"].any()


# ---------------------------------------------------------------------------
# test_models.py's MIND cases, on the port
# ---------------------------------------------------------------------------

def test_embedding_bag_combines():
    table = torch.as_tensor(np.arange(20, dtype=np.float32).reshape(10, 2))
    ids = torch.tensor([[1, 2, 0]])
    mask = torch.tensor([[True, True, False]])
    s = embedding_bag(table, ids, mask, combine="sum")
    np.testing.assert_allclose(s.numpy(), [[2 + 4, 3 + 5]])
    m = embedding_bag(table, ids, mask, combine="mean")
    np.testing.assert_allclose(m.numpy(), [[3.0, 4.0]])


def test_mind_interests_distinct_and_padding_ignored():
    cfg = MINDConfig(name="t", n_items=200, hist_len=8, n_interests=3)
    params = init_mind(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    hist = rng.integers(1, 200, (2, 8)).astype(np.int32)
    with torch.no_grad():
        base = user_tower(params, torch.as_tensor(hist), cfg)
        # padding positions (0) don't affect output
        hist2 = hist.copy()
        hist2[:, -2:] = 0
        hist3 = hist.copy()
        hist3[:, -2:] = 0
        out2 = user_tower(params, torch.as_tensor(hist2), cfg)
        out3 = user_tower(params, torch.as_tensor(hist3), cfg)
    np.testing.assert_allclose(out2.numpy(), out3.numpy(), atol=1e-6)
    # interests differ from each other (routing diversity)
    assert float((base[:, 0] - base[:, 1]).abs().max()) > 1e-4


def test_mind_retrieval_ranks_by_max_interest_dot():
    cfg = MINDConfig(name="t", n_items=50, hist_len=6)
    params = init_mind(cfg, torch.Generator().manual_seed(0), "cpu")
    hist = torch.as_tensor(np.random.default_rng(1).integers(1, 50, (3, 6)))
    with torch.no_grad():
        interests = user_tower(params, hist, cfg)
        cands = torch.arange(50)
        scores = score_candidates(params, interests, cands)
        expect = torch.einsum("bkd,nd->bkn", interests, params["item_embed"]).max(dim=1).values
    np.testing.assert_allclose(scores.numpy(), expect.numpy(), rtol=1e-5, atol=1e-6)
