"""The port's MoE layer (``repro_torch.models.moe``) and MoE language models
against the JAX package's on the same inputs: numpy-seeded tokens and the
reference's weights carried over.

Tolerances (float32).  Outputs and the auxiliary loss within rtol 1e-5 /
atol 1e-6, gradients within rtol 1e-4 plus 1e-6 of the leaf's largest
gradient: the two frameworks sum each product and the segment sum in
another order.  Integer outputs (top-k
ids, dispatch slots, the source token of each pair, the kept pairs) are
equal bit for bit, at an ample and at a tight capacity.  Whole MoE models
are held as the dense ones (``test_torch_lm.py``: rtol 1e-5 plus 5e-5 of
the largest logit); their gradients within rtol 1e-4 plus 2e-4 of the
leaf's largest gradient (over seeds 0-2 the largest difference was 1.1e-4
of it, kimi's ``wq``: the reference's init amplifies rounding, see
``test_torch_lm.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
import repro.configs.kimi_k2_1t_a32b as jkimi
import repro.configs.qwen3_moe_30b_a3b as jqwen
import repro_torch.configs.kimi_k2_1t_a32b as tkimi
import repro_torch.configs.qwen3_moe_30b_a3b as tqwen
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from test_torch_lm import assert_logits_close

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
T, D = 128, 16

# (n_experts, top_k, d_ff, n_shared, capacity_factor, n_groups, dense_mix);
# at T = 128 tokens the tight factors drop pairs in every group (the
# capacity rounds up to a multiple of 8)
CASES = {
    "ample_g1": (8, 2, 16, 0, 8.0, 1, False),
    "tight_g1": (8, 2, 16, 0, 0.5, 1, False),
    "ample_g4": (8, 2, 16, 0, 8.0, 4, False),
    "tight_g4": (8, 2, 16, 0, 0.5, 4, False),
    "shared_tight": (8, 2, 16, 1, 1.0, 1, False),
    "dense_mix_shared": (8, 2, 16, 1, 1.25, 1, True),
}
MOE_SMOKES = {"qwen3": (jqwen.SMOKE, tqwen.SMOKE), "kimi": (jkimi.SMOKE, tkimi.SMOKE)}


def _cfgs(case):
    E, K, F, S, cf, G, dm = CASES[case]
    kw = dict(n_experts=E, top_k=K, d_ff=F, n_shared=S, capacity_factor=cf, n_groups=G,
              dense_mix=dm)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _setup(case, seed=0):
    jcfg, tcfg = _cfgs(case)
    jparams, _ = jmoe.init_moe(jax.random.PRNGKey(seed), D, jcfg)
    tparams = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), jparams)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((T, D)).astype(np.float32)
    r = rng.standard_normal((T, D)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, x, r


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor)
                               else np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    """Output, auxiliary loss, and the gradients of sum(out * r) + aux with
    respect to every weight and to x, against ``jax.grad``."""
    jcfg, tcfg, jparams, tparams, x, r = _setup(case)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.moe_ffn(tparams, tx, tcfg)
    _close(out, jout, OUT_TOL)
    _close(aux, jaux, OUT_TOL)
    assert float(aux.detach()) > 0
    leaves = [tparams[k] for k in sorted(tparams) if k != "shared"]
    if "shared" in tparams:
        leaves += [tparams["shared"][k] for k in sorted(tparams["shared"])]
    grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(r)) + aux, leaves + [tx])
    want = [jgp[k] for k in sorted(jgp) if k != "shared"]
    if "shared" in jgp:
        want += [jgp["shared"][k] for k in sorted(jgp["shared"])]
    for got_g, want_g in zip(grads, want + [jgx]):
        _close(got_g, want_g, dict(rtol=1e-4, atol=1e-6 * float(jnp.abs(want_g).max())))


@pytest.mark.parametrize("case", ["ample_g1", "tight_g1", "tight_g4"])
def test_dispatch_integers_bit_identical(case):
    """Top-k ids, slots, source tokens and kept pairs of every group equal
    the reference's; at the tight capacity some pairs are dropped, the same
    ones on both sides."""
    jcfg, tcfg, jparams, tparams, x, _ = _setup(case, seed=3)
    E, K, G = jcfg.n_experts, jcfg.top_k, jcfg.n_groups
    C = tmoe.capacity(T, tcfg)
    assert C == jmoe.capacity(T, jcfg)
    probs = jax.nn.softmax(jnp.asarray(x) @ jparams["router"], -1)
    jw, jids = jax.lax.top_k(probs, K)
    with torch.no_grad():
        _, tw, tids, _ = tmoe._route(tparams, torch.as_tensor(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    dropped = 0
    xs, ws, ids = x.reshape(G, T // G, D), np.asarray(jw).reshape(G, -1, K), \
        np.asarray(jids).reshape(G, -1, K)
    for g in range(G):
        jout = jmoe._dispatch_group(jnp.asarray(xs[g]), jnp.asarray(ws[g]),
                                    jnp.asarray(ids[g]), E, K, C)
        tout = tmoe._dispatch_group(torch.tensor(xs[g]), torch.tensor(ws[g]),
                                    torch.tensor(ids[g]).long(), E, K, C)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))  # buf
        for i in (1, 2, 3):  # slot, token_of, keep
            np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
        np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))  # pair_w
        dropped += int((~tout[3]).sum())
    assert (dropped > 0) == ("tight" in case)


def test_moe_matches_dense_expert_computation():
    """With capacity ample, sort-based dispatch == per-token dense mixture
    (``test_models.py``, on the port)."""
    cfg = tmoe.MoEConfig(n_experts=4, top_k=2, d_ff=16, capacity_factor=8.0)
    gen = torch.Generator().manual_seed(2)
    params, _ = tmoe.init_moe(gen, 8, cfg)
    x = torch.randn((10, 8), generator=gen)
    got, aux = tmoe.moe_ffn(params, x, cfg)

    probs = torch.softmax(x @ params["router"], -1)
    top_w, top_ids = torch.topk(probs, 2)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for t in range(10):
        for j in range(2):
            e = int(top_ids[t, j])
            h = torch.nn.functional.silu(x[t] @ params["w_gate"][e]) * (x[t] @ params["w_up"][e])
            ref[t] += top_w[t, j] * (h @ params["w_down"][e])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
    assert float(aux.detach()) > 0


def test_moe_capacity_rounding():
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_ff=4)
    c = tmoe.capacity(1000, cfg)
    assert c % 8 == 0 and c >= 1000 * 2 / 8
    cfg_g = tmoe.MoEConfig(n_experts=8, top_k=2, d_ff=4, n_groups=4)
    cg = tmoe.capacity(1000, cfg_g)
    assert cg % 8 == 0 and cg >= (1000 // 4) * 2 / 8
    for n in (1, 7, 64, 1000, 4096):
        for kw in (dict(), dict(n_groups=4), dict(capacity_factor=16.0)):
            assert tmoe.capacity(n, tmoe.MoEConfig(8, 2, 4, **kw)) == \
                jmoe.capacity(n, jmoe.MoEConfig(8, 2, 4, **kw))


def test_moe_rejects_tokens_not_divisible_into_groups():
    _, tcfg, _, tparams, x, _ = _setup("ample_g4")
    with pytest.raises(ValueError, match="dispatch groups"):
        tmoe.moe_ffn(tparams, torch.as_tensor(x[:30]), tcfg)


def test_init_moe_draws_the_reference_shapes():
    for case in ("shared_tight", "ample_g1"):
        jcfg, tcfg = _cfgs(case)
        jp, jax_axes = jmoe.init_moe(jax.random.PRNGKey(0), D, jcfg)
        tp, t_axes = tmoe.init_moe(torch.Generator().manual_seed(0), D, tcfg)
        assert jax.tree_util.tree_map(lambda a: tuple(a.shape), jp) == \
            jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
        assert t_axes == jax_axes


# ---------------------------------------------------------------------------
# MoE language models on the reference's weights
# ---------------------------------------------------------------------------

def _both_moe_models(name, seed=0):
    jcfg, tcfg = MOE_SMOKES[name]
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, jcfg, ttf.params_from_numpy(tree, tcfg, "cpu")


@pytest.mark.parametrize("name", list(MOE_SMOKES))
def test_moe_lm_forward_and_loss_match_jax(name):
    params, jcfg, model = _both_moe_models(name)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) < 0.7).astype(np.float32)
    want, waux = jtf.forward(params, jnp.asarray(toks), jcfg)
    got, aux = ttf.forward(model, torch.as_tensor(toks))
    assert_logits_close(got.detach().numpy(), want)
    _close(aux, waux, OUT_TOL)
    assert float(aux.detach()) > 0
    batch = {"tokens": toks, "labels": labels, "mask": mask}
    (wl, wm), wg = jax.value_and_grad(lambda p: jtf.loss_fn(p, batch, jcfg), has_aux=True)(
        params)
    loss, metrics = ttf.loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(loss, wl, OUT_TOL)
    _close(metrics["ce"], wm["ce"], OUT_TOL)
    grads = torch.autograd.grad(loss, [p for _, p in _items(model.params)])
    for (key, g), (_, w) in zip(zip([k for k, _ in _items(model.params)], grads),
                                _items(wg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=2e-4 * np.abs(np.asarray(w)).max(), err_msg=key)


def _items(tree):
    from repro_torch.tree import tree_items

    return list(tree_items(tree))


@pytest.mark.parametrize("name", list(MOE_SMOKES))
def test_moe_lm_prefill_and_decode_match_jax(name):
    """A MoE model's prefill and decode step (T = the batch's rows, so the
    capacity follows the rows) against the reference's."""
    params, jcfg, model = _both_moe_models(name, seed=1)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (3, 16)).astype(np.int32)
    want, wcache = jtf.prefill(params, jnp.asarray(toks), jcfg, max_seq=24)
    got, gcache = ttf.prefill(model, torch.as_tensor(toks), max_seq=24)
    assert_logits_close(got.numpy(), want)
    nxt = np.asarray([3, 77, 120], np.int32)
    lens = np.asarray([16, 9, 1], np.int32)
    want, wnew = jtf.decode_step(params, wcache, jnp.asarray(nxt), jnp.asarray(lens), jcfg)
    got, gnew = ttf.decode_step(model, gcache, torch.as_tensor(nxt), torch.as_tensor(lens))
    assert_logits_close(got.numpy(), want)
    for key in ("k", "v"):
        assert_logits_close(gnew[key].numpy(), wnew[key])


def test_moe_param_counts_and_layout_match_jax():
    for name, (jcfg, tcfg) in MOE_SMOKES.items():
        assert tcfg.n_params == jcfg.n_params and tcfg.n_active_params == jcfg.n_active_params
        params, _, model = _both_moe_models(name)
        assert sum(p.numel() for p in model.parameters()) == \
            sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(params))
        back = ttf.params_to_numpy(model)
        for (k, a), (_, b) in zip(_items(back), _items(jax.tree_util.tree_map(np.asarray,
                                                                              params))):
            np.testing.assert_array_equal(a, b, err_msg=k)
        blk = model.layers[1]
        assert torch.equal(blk.moe["w_gate"], model.params["layers"]["moe"]["w_gate"][1])
    assert dataclasses.asdict(tqwen.CFG.moe) == dataclasses.asdict(jqwen.CFG.moe)


@pytest.mark.parametrize("router", ["zero", "tied"])
@pytest.mark.parametrize("dense_mix", [False, True])
def test_route_breaks_ties_as_jax(router, dense_mix):
    """Equal router probabilities pick the lower expert ids first, as
    ``jax.lax.top_k`` does (E 4, K 2, T 8, d 4): a zero router ties every
    expert, a tied one pairs experts {0, 2} and {1, 3} by equal columns.
    Top-k ids bit for bit, outputs and the auxiliary loss within OUT_TOL."""
    kw = dict(n_experts=4, top_k=2, d_ff=8, capacity_factor=8.0, dense_mix=dense_mix)
    jcfg, tcfg = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
    jparams, _ = jmoe.init_moe(jax.random.PRNGKey(0), 4, jcfg)
    rng = np.random.default_rng(7)
    if router == "zero":
        w = np.zeros((4, 4), np.float32)
    else:
        col = rng.standard_normal((4, 2)).astype(np.float32)
        w = np.concatenate([col, col], axis=1)
    jparams = dict(jparams, router=jnp.asarray(w))
    tparams = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), jparams)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jparams["router"], -1), 2)
    with torch.no_grad():
        _, _, tids, _ = tmoe._route(tparams, torch.as_tensor(x), tcfg)
        out, aux = tmoe.moe_ffn(tparams, torch.as_tensor(x), tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    if router == "zero":
        assert (tids.numpy() == [0, 1]).all()
    jout, jaux = jmoe.moe_ffn(jparams, jnp.asarray(x), jcfg)
    _close(out, jout, OUT_TOL)
    _close(aux, jaux, OUT_TOL)
