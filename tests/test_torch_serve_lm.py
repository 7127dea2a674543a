"""The port's continuous-batching engine (``repro_torch.serve.engine``)
against the JAX package's ``ServeEngine`` on the same weights: each of
``tests/test_serve.py``'s five tests, mirrored, with both engines' tokens
and ``EngineStats`` required identical and the port's tokens equal to a
greedy decode through the port's ``forward``.  Then the launcher's LM mode
on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Request, ServeEngine

JCFG = jtf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                    d_ff=64, vocab=64, dtype=jnp.float32, q_chunk=8, kv_chunk=8)
TCFG = ttf.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                    d_ff=64, vocab=64, dtype=torch.float32, q_chunk=8, kv_chunk=8)


def _weights(seed):
    params = jtf.init_params(jax.random.PRNGKey(seed), JCFG)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, ttf.params_from_numpy(tree, TCFG, "cpu")


def _greedy_reference(model, prompt, n_new, pad_to):
    toks = list(prompt.tolist())
    for _ in range(n_new):
        arr = np.zeros((1, pad_to), np.int32)
        arr[0, : len(toks)] = toks
        logits, _ = ttf.forward(model, torch.as_tensor(arr))
        toks.append(int(torch.argmax(logits[0, len(toks) - 1])))
    return toks[len(prompt):]


def _serve_both(seed, prompts, budgets, slots, max_seq):
    """Both engines over the same requests; returns (port requests, port
    stats, model) after checking tokens and stats are identical."""
    params, model = _weights(seed)
    jeng = JServeEngine(params, JCFG, batch_slots=slots, max_seq=max_seq)
    teng = ServeEngine(model, batch_slots=slots, max_seq=max_seq)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=b)
             for i, (p, b) in enumerate(zip(prompts, budgets))]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=b)
             for i, (p, b) in enumerate(zip(prompts, budgets))]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jstats, tstats = jeng.run(), teng.run()
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated, (tr.rid, tr.generated, jr.generated)
    return treqs, tstats, model


def test_engine_matches_reference_greedy():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, 8).astype(np.int32) for _ in range(3)]
    reqs, stats, model = _serve_both(0, prompts, [5] * 3, slots=2, max_seq=32)
    assert stats.requests_completed == 3
    for r in reqs:
        assert r.generated == _greedy_reference(model, r.prompt, 5, 32)


def test_engine_respects_max_new_tokens():
    _, stats, _ = _serve_both(1, [np.asarray([1, 2, 3], np.int32)], [4], slots=4,
                              max_seq=24)
    assert stats.tokens_generated == 4


def test_engine_single_token_budget_emits_exactly_one():
    prompt = np.asarray([1, 2, 3], np.int32)
    (req,), stats, model = _serve_both(1, [prompt], [1], slots=2, max_seq=24)
    assert stats.tokens_generated == 1
    assert stats.requests_completed == 1
    assert req.generated == _greedy_reference(model, prompt, 1, 24)
    assert stats.steps == 0  # the slot was never occupied


def test_engine_zero_token_budget_completes_without_tokens():
    prompts = [np.asarray([1, 2, 3], np.int32), np.asarray([4, 5, 6], np.int32)]
    (empty, real), stats, model = _serve_both(1, prompts, [0, 3], slots=1, max_seq=24)
    assert empty.generated == []
    assert stats.requests_completed == 2
    assert stats.tokens_generated == 3
    assert real.generated == _greedy_reference(model, real.prompt, 3, 24)


def test_engine_mixed_budgets_share_slots():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, 6).astype(np.int32) for _ in range(4)]
    budgets = [1, 0, 3, 2]
    reqs, stats, model = _serve_both(0, prompts, budgets, slots=2, max_seq=24)
    assert stats.requests_completed == 4
    assert stats.tokens_generated == sum(budgets)
    for r, b in zip(reqs, budgets):
        assert len(r.generated) == b, (r.rid, r.generated)
        assert r.generated == _greedy_reference(model, r.prompt, b, 24)


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    stats = launch_serve.main(["--arch", "phi4-mini-3.8b", "--requests", "3", "--slots", "2",
                               "--max-new", "3", "--prompt-len", "8", "--max-seq", "16",
                               "--device", "cpu"])
    assert (stats.requests_completed, stats.tokens_generated) == (3, 9)
    assert "completed 3/3 requests, 9 tokens" in capsys.readouterr().out
