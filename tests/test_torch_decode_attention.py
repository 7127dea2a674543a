"""K4, the flash-decode kernel's plain version (``repro_torch.kernels.
decode_attention``), against the JAX package's Pallas kernel (interpret
mode) and its oracle ``models/layers.py::decode_attention``, on the same
numpy inputs.  Tolerances are the reference's own (rtol/atol 2e-5, from
``test_extensions.py``) unless a test says otherwise.  The kernel itself
runs only on the card (``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.kernels.decode_attention import decode_attention_pallas
from repro.models.layers import decode_attention as jax_decode_attention
from repro_torch.kernels import decode_attention as k4
from repro_torch.models.layers import decode_attention as layers_decode_attention

TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = [  # B, S, H, KH, Dh, block_s (the reference's kernel tests)
    (2, 64, 4, 2, 16, 16),
    (3, 100, 8, 4, 32, 32),       # ragged: S not a block multiple
    (1, 33, 2, 1, 8, 16),
    (2, 128, 8, 8, 16, 64),       # MHA (G=1)
    (2, 96, 16, 2, 16, 32),       # G=8, the kernel's largest group
]


def _inputs(B, S, H, KH, Dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(dtype)
    k = rng.standard_normal((B, S, KH, Dh)).astype(dtype)
    v = rng.standard_normal((B, S, KH, Dh)).astype(dtype)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    return q, k, v, lens


def _port(q, k, v, lens):
    return k4.decode_attention(*(torch.as_tensor(a) for a in (q, k, v, lens)))


@pytest.mark.parametrize("B,S,H,KH,Dh,bs", SHAPES)
def test_plain_matches_pallas_kernel_and_oracle(B, S, H, KH, Dh, bs):
    q, k, v, lens = _inputs(B, S, H, KH, Dh, seed=S)
    got = _port(q, k, v, lens).numpy()
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lens), block_s=bs)
    oracle = np.concatenate([
        np.asarray(jax_decode_attention(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                                        jnp.asarray(v[b:b + 1]), int(lens[b])))
        for b in range(B)])
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_respects_lengths():
    """Entries past cache_len must not influence the output."""
    q, k, v, _ = _inputs(1, 32, 2, 1, 8, seed=7)
    lens = np.asarray([10], np.int32)
    out1 = _port(q, k, v, lens)
    k2, v2 = k.copy(), v.copy()
    k2[:, 10:] = 99.0
    v2[:, 10:] = -99.0
    out2 = _port(q, k2, v2, lens)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2),
                                     jnp.asarray(lens), block_s=16)
    np.testing.assert_allclose(out2.numpy(), np.asarray(pallas), **TOL)


def test_cache_len_zero_gives_zeros():
    """A row with no valid position: the port gives zeros (the reference
    kernel's max(l, 1e-30) guard); the Pallas kernel gives the mean of the
    padded V block (its masked scores are the finite -1e30), the oracle NaN.
    Rows with a length are unaffected."""
    q, k, v, _ = _inputs(2, 16, 4, 2, 8, seed=3)
    lens = np.asarray([0, 9], np.int32)
    got = _port(q, k, v, lens).numpy()
    assert (got[0] == 0).all()
    pallas = np.asarray(decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), jnp.asarray(lens),
                                                block_s=16))
    np.testing.assert_allclose(got[1], pallas[1], **TOL)
    mean_v = v[0].mean(axis=0).repeat(2, axis=0)  # [KH * G, Dh]
    np.testing.assert_allclose(pallas[0], mean_v, **TOL)
    oracle = np.asarray(jax_decode_attention(jnp.asarray(q[:1]), jnp.asarray(k[:1]),
                                             jnp.asarray(v[:1]), 0))
    assert np.isnan(oracle).all()


@pytest.mark.parametrize("cache_len", [5, 16])
def test_layers_entry_takes_a_scalar_length(cache_len):
    """``models.layers.decode_attention`` takes the reference's scalar (or
    [B]) length and routes to K4's wrapper."""
    q, k, v, _ = _inputs(2, 16, 4, 2, 8, seed=cache_len)
    got = layers_decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), cache_len)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bfloat16_rounds_as_the_oracle():
    """bfloat16 inputs: q * scale and p are rounded to bfloat16 as the
    oracle rounds them; the output, in bfloat16, is within one bfloat16
    rounding (2**-8 relative) of the oracle's."""
    q, k, v, lens = _inputs(2, 64, 4, 2, 16, seed=11)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = k4.decode_attention(tq, tk, tv, torch.as_tensor(lens))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.concatenate([
        np.asarray(jax_decode_attention(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1],
                                        int(lens[b])), np.float32)
        for b in range(2)])
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-8, atol=2**-8)


def test_cpu_call_runs_the_plain_version_uncounted():
    q, k, v, lens = _inputs(2, 8, 2, 1, 4, seed=1)
    before = k4.decode_attention.launches
    got = _port(q, k, v, lens)
    assert k4.decode_attention.launches == before
    want = k4.decode_attention_plain(*(torch.as_tensor(a) for a in (q, k, v, lens)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("S,splits", [
    (1, 1), (64, 1), (65, 2), (300, 5),     # 64 positions per split at least
    (2048, 32), (2049, 22), (32768, 32),    # at most 32 splits per row
])
def test_split_scratch_sizes(S, splits):
    """The partial-softmax scratch holds the most splits a row of S
    positions can have: splits of at least 64 positions, a multiple of 32,
    and at most 32 of them."""
    assert k4.split_scratch(8, S, 8, 3, 128) == (8, 8, splits, 3, 132)
    assert splits <= k4.MAX_SPLIT and (splits - 1) * k4.MIN_CHUNK < S


@pytest.mark.parametrize("bad", ["kv_heads", "v_shape", "len_dtype", "len_shape", "dtype"])
def test_wrapper_rejects_bad_input(bad):
    q, k, v, lens = (torch.as_tensor(a) for a in _inputs(2, 8, 4, 2, 4, seed=2))
    if bad == "kv_heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "v_shape":
        v = v[:, :4]
    elif bad == "len_dtype":
        lens = lens.long()
    elif bad == "len_shape":
        lens = lens[:1]
    else:
        k = k.double()
    with pytest.raises((ValueError, TypeError)):
        k4.decode_attention(q, k, v, lens)
