"""The port's language model (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's on the same inputs: layers on numpy-seeded
tensors, and the whole model on the reference's weights carried over with
``params_from_numpy``, at both reduced configs (phi4-mini's: GQA group 2,
d_head 12; SmolLM's: tied head, group 1; float32).

Tolerances.  Layers are held to the reference's own (2e-5 for attention,
``test_models.py``).  Whole-model logits, caches included, are held to
rtol 1e-5 plus 5e-5 of the largest reference value: the two frameworks sum
each matmul in another order and XLA contracts elementwise chains into
FMAs, and the reference's init (``normal / sqrt(shape[-2])``, so ``wq``
scales by 1/sqrt(H)) makes scores large and the softmax sharp, which
amplifies those last-bit differences.  Over seeds 0-2 at these sizes the
largest difference measured was 1.5e-5 of the largest logit.

``test_models.py::test_unroll_matches_scan`` has no counterpart: it tests a
JAX mechanism (``lax.scan`` against an unrolled trace), and the port's
layers are one Python loop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
import repro.configs.phi4_mini_3_8b as jphi
import repro.configs.smollm_135m as jsmol
import repro_torch.configs.phi4_mini_3_8b as tphi
import repro_torch.configs.smollm_135m as tsmol
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
SMOKES = {"phi4": (jphi.SMOKE, tphi.SMOKE), "smollm": (jsmol.SMOKE, tsmol.SMOKE)}


def assert_logits_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5 * np.abs(want).max())


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _both_models(name, seed=0):
    jcfg, tcfg = SMOKES[name]
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, jcfg, ttf.params_from_numpy(tree, tcfg, "cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    g = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl.rms_norm(jnp.asarray(x, jdt), jnp.asarray(g, jdt))
    got = tl.rms_norm(_t(x).to(tdt), _t(g).to(tdt))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2**-7  # bfloat16: one rounding of the product
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d_head", [12, 128])
def test_rope_matches_jax(d_head):
    """Frequencies and angles in float32 on both sides; torch.pow and XLA's
    power may differ by an ulp, so the tolerance is float32's at the
    largest angle (position 2047)."""
    rng = np.random.default_rng(d_head)
    x = rng.standard_normal((2, 16, 3, d_head)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 16))
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4)
    got = tl.rope(_t(x), _t(pos), theta=1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_rope_relative_property():
    """RoPE: <q_m, k_n> depends only on (m - n)."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((1, 1, 1, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 1, 1, 16)).astype(np.float32))

    def dot_at(m, n):
        qm = tl.rope(q, torch.tensor([[m]]), theta=1e4)
        kn = tl.rope(k, torch.tensor([[n]]), theta=1e4)
        return float((qm * kn).sum())

    assert dot_at(5, 3) == pytest.approx(dot_at(102, 100), rel=1e-4)
    assert dot_at(7, 7) == pytest.approx(dot_at(0, 0), rel=1e-4)


def _naive_attention(q, k, v):
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    qr = q.reshape(B, S, KH, H // KH, Dh)
    s = np.einsum("bqhgd,bkhd->bhgqk", qr, k) / np.sqrt(Dh)
    s = np.where(np.tril(np.ones((S, S), bool))[None, None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhgqk,bkhd->bhgqd", p, v)
    return out.transpose(0, 3, 1, 2, 4).reshape(B, S, H, Dh)


def _qkv(B, S, H, KH, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, Dh)).astype(np.float32),
            rng.standard_normal((B, S, KH, Dh)).astype(np.float32),
            rng.standard_normal((B, S, KH, Dh)).astype(np.float32))


@pytest.mark.parametrize("q_chunk,kv_chunk", [(8, 8), (16, 4), (32, 32)])
def test_flash_attention_matches_jax_and_naive(q_chunk, kv_chunk):
    q, k, v = _qkv(2, 32, 4, 2, 16, seed=q_chunk)
    got = tl.flash_attention(_t(q), _t(k), _t(v), causal=True, q_chunk=q_chunk,
                             kv_chunk=kv_chunk).numpy()
    want = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got, np.asarray(want), **ATTN_TOL)
    np.testing.assert_allclose(got, _naive_attention(q, k, v), **ATTN_TOL)


def test_flash_attention_rejects_a_ragged_chunking():
    """A sequence longer than q_chunk that is not a multiple of it: the
    reference's reshape raises, and so does the port."""
    q, k, v = _qkv(1, 20, 2, 1, 8, seed=0)
    with pytest.raises(TypeError):
        jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=8,
                           kv_chunk=8)
    with pytest.raises(ValueError, match="multiple"):
        tl.flash_attention(_t(q), _t(k), _t(v), q_chunk=8, kv_chunk=8)


def test_decode_matches_full_attention():
    q, k, v = _qkv(2, 9, 4, 2, 8, seed=5)
    full = _naive_attention(q, k, v)
    got = tl.decode_attention(_t(q[:, -1]), _t(k), _t(v), 9)
    np.testing.assert_allclose(got.numpy(), full[:, -1], **ATTN_TOL)


def test_cross_entropy_masked():
    """``test_models.py``'s masked cross-entropy, on the port, and both
    forms against the reference on random logits (float32, rtol 1e-6)."""
    logits = torch.tensor([[[2.0, 0.0], [0.0, 2.0]]])
    labels = torch.tensor([[0, 0]])
    mask = torch.tensor([[1.0, 0.0]])
    assert float(tl.softmax_cross_entropy(logits, labels, mask)) < \
        float(tl.softmax_cross_entropy(logits, labels))
    rng = np.random.default_rng(3)
    lg = (rng.standard_normal((3, 7, 50)) * 5).astype(np.float32)
    lb = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mk = (rng.random((3, 7)) < 0.5).astype(np.float32)
    for m in (None, mk, np.zeros_like(mk)):
        want = jl.softmax_cross_entropy(jnp.asarray(lg), jnp.asarray(lb),
                                        None if m is None else jnp.asarray(m))
        got = tl.softmax_cross_entropy(_t(lg), _t(lb), None if m is None else _t(m))
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

def test_registry_carries_the_reference_widths():
    from repro.configs import list_archs as jlist_archs

    assert list_archs() == jlist_archs()   # every family, since the GNN / NequIP / MIND port
    assert [a for a in list_archs() if get_arch(a).family == "lm"] == [
        "kimi-k2-1t-a32b", "mistral-large-123b", "phi4-mini-3.8b",
        "qwen3-moe-30b-a3b", "smollm-135m"]
    with pytest.raises(KeyError):
        get_arch("nope")
    fields = [f.name for f in dataclasses.fields(ttf.LMConfig) if f.name != "dtype"]
    for arch, jmod in (("phi4-mini-3.8b", jphi), ("smollm-135m", jsmol)):
        spec = get_arch(arch)
        for tcfg, jcfg in ((spec.cfg, jmod.CFG), (spec.smoke_cfg, jmod.SMOKE)):
            assert {f: getattr(tcfg, f) for f in fields} == \
                {f: getattr(jcfg, f) for f in fields}
            assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
            assert tcfg.n_params == jcfg.n_params
            assert tcfg.head_dim == jcfg.head_dim


def test_init_draws_the_reference_distribution():
    """Each weight's spread follows the reference's fan-in rule, sqrt of the
    last-but-one axis (H for wq, not d_model): within 10% of the JAX init's
    standard deviation, weight by weight."""
    jcfg, tcfg = SMOKES["phi4"]
    tcfg = dataclasses.replace(tcfg, n_layers=4)
    jcfg = dataclasses.replace(jcfg, n_layers=4)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    model = ttf.init_lm(tcfg, gen, "cpu")
    ref = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    blocks = {n: torch.stack([getattr(b, n) for b in model.layers]) for n in ref["layers"]}
    for name, want in [*ref["layers"].items(), ("embed", ref["embed"]),
                       ("lm_head", ref["lm_head"])]:
        got = blocks[name] if name in blocks else getattr(model, name)
        assert got.shape == want.shape and got.device.type == "cpu"
        assert float(got.detach().std()) == pytest.approx(float(jnp.std(want)), rel=0.1), name
    assert float(blocks["wq"].std()) == pytest.approx(1 / np.sqrt(tcfg.n_heads), rel=0.1)
    assert (blocks["ln1"] == 1).all() and (model.final_ln == 1).all()
    # the weights take gradients (training); serving runs under inference_mode
    assert all(p.requires_grad for p in model.parameters())


def test_params_from_numpy_carries_bfloat16_bits():
    """A bfloat16 numpy array (ml_dtypes) reaches torch through its 16 bits."""
    jcfg, tcfg = SMOKES["smollm"]
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jtf.init_params(jax.random.PRNGKey(3), jcfg))
    model = ttf.params_from_numpy(tree, tcfg, "cpu")
    assert model.embed.dtype == torch.bfloat16
    assert (model.embed.detach().view(torch.int16).numpy() == tree["embed"].view(np.int16)).all()
    wq = model.layers[1].wq.detach().view(torch.int16).numpy()
    assert (wq == tree["layers"]["wq"][1].view(np.int16)).all()
    with pytest.raises(ValueError, match="shape"):
        ttf.params_from_numpy(tree, dataclasses.replace(tcfg, d_ff=64), "cpu")


# ---------------------------------------------------------------------------
# the whole model against JAX on carried-over weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SMOKES))
def test_forward_matches_jax(name):
    params, jcfg, model = _both_models(name)
    toks = _tokens(jcfg.vocab, (2, 32), seed=1)
    want, _ = jtf.forward(params, jnp.asarray(toks), jcfg)
    got, aux = ttf.forward(model, _t(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 32, jcfg.vocab)
    assert_logits_close(got.detach().numpy(), want)
    assert float(aux) == 0.0  # dense: no MoE auxiliary loss


@pytest.mark.parametrize("name", list(SMOKES))
def test_prefill_matches_jax(name):
    params, jcfg, model = _both_models(name, seed=1)
    toks = _tokens(jcfg.vocab, (2, 16), seed=2)
    want, wcache = jtf.prefill(params, jnp.asarray(toks), jcfg, max_seq=24)
    got, gcache = ttf.prefill(model, _t(toks), max_seq=24)
    assert_logits_close(got.numpy(), want)
    for key in ("k", "v"):
        assert gcache[key].shape == wcache[key].shape
        assert_logits_close(gcache[key].numpy(), wcache[key])


@pytest.mark.parametrize("name", list(SMOKES))
def test_decode_step_matches_jax(name):
    """Ragged per-row lengths; each side decodes from its own fresh prefill
    cache (the port writes into its cache in place)."""
    params, jcfg, model = _both_models(name, seed=2)
    toks = _tokens(jcfg.vocab, (3, 16), seed=3)
    _, wcache = jtf.prefill(params, jnp.asarray(toks), jcfg, max_seq=24)
    _, gcache = ttf.prefill(model, _t(toks), max_seq=24)
    nxt = _tokens(jcfg.vocab, (3,), seed=4)
    lens = np.asarray([16, 9, 1], np.int32)
    want, wnew = jtf.decode_step(params, wcache, jnp.asarray(nxt), jnp.asarray(lens), jcfg)
    got, gnew = ttf.decode_step(model, gcache, _t(nxt), _t(lens))
    assert gnew is gcache
    assert_logits_close(got.numpy(), want)
    for key in ("k", "v"):
        assert_logits_close(gnew[key].numpy(), wnew[key])


@pytest.mark.parametrize("name", ["t", *SMOKES])
def test_prefill_decode_match_forward(name):
    """Port only, as ``test_models.py::test_prefill_decode_match_forward``:
    prefill's last logits equal forward's, and one decode step equals
    forward over the prompt and the new token (padded to a chunk multiple)."""
    if name == "t":
        cfg = ttf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                           d_ff=64, vocab=96, dtype=torch.float32, q_chunk=8, kv_chunk=8)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        model = ttf.init_lm(cfg, gen, "cpu")
    else:
        _, _, model = _both_models(name, seed=5)
        cfg = model.cfg
    toks = _t(_tokens(cfg.vocab, (2, 16), seed=5))
    logits = ttf.forward(model, toks)[0].detach()
    last, cache = ttf.prefill(model, toks, max_seq=32)
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), rtol=1e-5, atol=1e-5)
    nxt = torch.argmax(last, -1).to(torch.int32)
    dl, _ = ttf.decode_step(model, cache, nxt, torch.full((2,), 16, dtype=torch.int32))
    toks17 = torch.cat([toks, nxt[:, None]], 1)
    lg = ttf.forward(model, torch.nn.functional.pad(toks17, (0, 15)))[0].detach()
    np.testing.assert_allclose(dl.numpy(), lg[:, 16].numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_init_cache_dtype_matches_jax(dtype, mesh):
    """``init_cache(cfg, batch, max_seq, dtype)`` on a bfloat16 config: the
    JAX package's zeros in ``dtype`` (the config's when None), the dtype
    taken in the reference's fourth position, with and without a mesh."""
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import is_dtensor, use_mesh

    jcfg, tcfg = (dataclasses.replace(c, dtype=d) for c, d in
                  zip(SMOKES["smollm"], (jnp.bfloat16, torch.bfloat16)))
    want = jtf.init_cache(jcfg, 2, 24, None if dtype is None else getattr(jnp, dtype))
    with test_torch_common.one_rank_group():
        m = make_mesh((1, 1), ("data", "model"), device="cpu") if mesh else None
        with use_mesh(m):
            got = ttf.init_cache(tcfg, 2, 24, None if dtype is None else getattr(torch, dtype),
                                 device="cpu")
        for key in ("k", "v"):
            assert is_dtensor(got[key]) == mesh
            local = got[key].to_local() if mesh else got[key]
            assert str(local.dtype) == "torch." + want[key].dtype.name
            assert local.shape == want[key].shape
            assert (local.float().numpy() == np.asarray(want[key], np.float32)).all()


def test_tied_embeddings_have_no_lm_head():
    cfg = ttf.LMConfig(name="t", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1,
                       d_ff=32, vocab=32, tie_embeddings=True, dtype=torch.float32,
                       q_chunk=8, kv_chunk=8)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    model = ttf.init_lm(cfg, gen, "cpu")
    assert not hasattr(model, "lm_head")
    assert "lm_head" not in dict(model.named_parameters())
    assert "lm_head" not in model.params
    logits, _ = ttf.forward(model, torch.zeros((1, 8), dtype=torch.int32))
    assert logits.shape == (1, 8, 32)
    # the tied smoke config against the reference's
    params, jcfg, tmodel = _both_models("smollm", seed=6)
    assert "lm_head" not in params and not hasattr(tmodel, "lm_head")


@pytest.mark.parametrize("n_layers", [1, 10])
def test_reference_init_amplifies_rounding_with_depth(n_layers):
    """The reference's init scales wq by 1/sqrt(H) and wk by 1/sqrt(KH),
    not 1/sqrt(d): at phi4-mini's ratios (d / H = 128, d / KH = 384, here at
    d_model 768) attention scores spread ~220 wide, the softmax is nearly
    one-hot, and rounding-level differences grow layer by layer.  Shown on
    the reference alone: its float32 logits with every embedding moved by
    one ulp stay within 1e-4 of the largest logit after one layer and move
    by more than 5e-2 after ten.  The port is held to the reference layer
    by layer, each block fed the reference's input to it, within the
    whole-model tolerance.  This is why full-depth served tokens are checked
    block by block on the card (``chip_smoke.py``), not token for token."""
    kw = dict(name="p", n_layers=n_layers, d_model=768, n_heads=6, n_kv_heads=2, d_head=128,
              d_ff=2048, vocab=64, rope_theta=1e4, q_chunk=64, kv_chunk=64)
    jcfg = jtf.LMConfig(**kw, dtype=jnp.float32)
    tcfg = ttf.LMConfig(**kw, dtype=torch.float32)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(64, (1, 64), seed=0)
    want = np.asarray(jtf.forward(params, jnp.asarray(toks), jcfg)[0])
    nudged = dict(params, embed=jnp.asarray(np.nextafter(np.asarray(params["embed"]),
                                                         np.float32(np.inf))))
    moved = np.asarray(jtf.forward(nudged, jnp.asarray(toks), jcfg)[0])
    rel = np.abs(moved - want).max() / np.abs(want).max()
    assert rel < 1e-4 if n_layers == 1 else rel > 5e-2

    model = ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    positions = jnp.broadcast_to(jnp.arange(64), (1, 64))
    rot = tl.rope_tables(torch.arange(64)[None], tcfg.head_dim, tcfg.rope_theta)
    h = params["embed"][jnp.asarray(toks)]
    for i, blk in enumerate(model.layers):
        lp = jax.tree_util.tree_map(lambda x, i=i: x[i], params["layers"])
        h_next, _ = jtf._layer_body(jcfg, h, lp, positions)
        with torch.no_grad():
            got, _, _, _ = ttf.layer_forward(tcfg, blk, _t(h), rot)
        assert_logits_close(got.numpy(), h_next)
        h = h_next
