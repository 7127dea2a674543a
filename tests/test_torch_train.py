"""The port's training substrate (``repro_torch.train``,
``repro_torch.distributed.compression``, ``repro_torch.launch.train``)
against the JAX package's: every test of ``test_train.py`` mirrored on the
port, then the same inputs through both packages.

Tolerances (float32).  Pure functions on the same tensors: the schedule,
norms, int8 scales and the optimizers' updates within rtol 1e-6 / atol
1e-7; int8 codes and top-k masks bit for bit.  Whole train steps on the
reference's weights carried over (the four reduced configs, 3 steps):
losses within rtol 1e-5, gradient norms within rtol 1e-4; every parameter
within 2.5 ``lr`` of the reference's and all but 1 in 10^4 entries within
1e-5 of the leaf's largest value.  An AdamW or Adafactor step moves an
entry by about ``lr`` x sign(g) at first, so an entry whose gradient the
two frameworks round to opposite signs (|g| at the rounding level) lands
up to 2 lr apart: measured 0.23 lr on the reduced configs, 2.00003 lr on
one entry of the stacked configuration.
With int8 or top-k compression a code or a kept entry at the rounding
boundary flips, and error feedback carries it: those steps are held by the
loss, the gradient norm (rtol 1e-3) and all but 1% of the entries.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.configs import get_arch as jget
from repro.data.tokens import MarkovCorpus as JCorpus
from repro.distributed import compression as jcomp
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import get_arch as tget
from repro_torch.distributed.compression import (
    CompressionConfig,
    compress_gradients,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
    wire_bytes,
)
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import StragglerMonitor, build_mesh_from_plan, plan_remesh
from repro_torch.train.optimizer import (
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgd,
    state_axes,
    warmup_cosine,
)
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
from repro_torch.tree import tree_items, tree_leaves, tree_map

FN_TOL = dict(rtol=1e-6, atol=1e-7)
LR = 3e-4  # the families' default rate


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# test_train.py, mirrored on the port
# ---------------------------------------------------------------------------

def _quadratic_problem():
    target = torch.tensor([1.0, -2.0, 3.0])

    def loss(params, batch):
        del batch
        return torch.sum((params["w"] - target) ** 2), {}

    return loss, {"w": torch.zeros(3)}


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_optimizers_converge_on_quadratic(kind):
    loss, params = _quadratic_problem()
    kw = {"weight_decay": 0.0} if kind in ("adamw", "adafactor") else {}
    opt = make_optimizer(kind, 0.1, **kw)
    step = make_train_step(loss, opt, TrainConfig(max_grad_norm=100.0))
    state = init_train_state(params, opt, TrainConfig())
    for _ in range(300):
        params, state, m = step(params, state, {})
    assert float(m["loss"]) < 1e-2


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_warmup_cosine_shape():
    sched = warmup_cosine(1.0, 10, 100)
    assert float(sched(0)) == 0.0
    assert float(sched(10)) == pytest.approx(1.0)
    assert float(sched(100)) == pytest.approx(0.1, rel=1e-2)


def test_adafactor_state_is_factored():
    opt = adafactor(1e-2)
    params = {"big": torch.zeros((256, 512)), "small": torch.zeros((4, 4))}
    state = opt.init(params)
    assert state["big"]["vr"].shape == (256,)
    assert state["big"]["vc"].shape == (512,)
    assert state["small"]["v"].shape == (4, 4)
    axes = state_axes("adafactor", {"big": ("fsdp", "mlp"), "small": (None, None)}, params)
    assert axes["big"] == {"vr": ("fsdp",), "vc": ("mlp",)}


def test_microbatching_matches_full_batch():
    """Each step gets its own copy of the parameters and state: the port's
    optimizer updates them in place."""
    loss = lambda p, b: (torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), {})
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    batch = {"x": _t(rng.standard_normal((8, 4)).astype(np.float32)),
             "y": _t(rng.standard_normal((8, 2)).astype(np.float32))}
    opt = sgd(0.1, momentum=0.0)
    s1 = make_train_step(loss, opt, TrainConfig(microbatches=1, max_grad_norm=1e9))
    s4 = make_train_step(loss, opt, TrainConfig(microbatches=4, max_grad_norm=1e9))
    p1 = {"w": _t(w)}
    p4 = {"w": _t(w)}
    p1, _, _ = s1(p1, init_train_state(p1, opt, TrainConfig()), batch)
    p4, _, _ = s4(p4, init_train_state(p4, opt, TrainConfig()), batch)
    np.testing.assert_allclose(_np(p1["w"]), _np(p4["w"]), rtol=1e-5, atol=1e-6)


def test_int8_roundtrip_error_bounded():
    x = _t(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, s = quantize_int8(x)
    err = torch.abs(dequantize_int8(q, s) - x)
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates():
    """With error feedback, the SUM of compressed grads tracks the true sum."""
    rng = np.random.default_rng(1)
    grads = [{"w": _t((rng.standard_normal(64) * 0.01).astype(np.float32))}
             for _ in range(50)]
    cfg = CompressionConfig(kind="int8")
    err = init_error_feedback(grads[0])
    total_c = torch.zeros(64)
    total_t = torch.zeros(64)
    for g in grads:
        gc, err = compress_gradients(g, err, cfg)
        total_c += gc["w"]
        total_t += g["w"]
    resid = float(torch.abs(total_c + err["w"] - total_t).max())
    assert resid < 1e-4


def test_topk_keeps_fraction():
    cfg = CompressionConfig(kind="topk", topk_ratio=0.1)
    g = {"w": _t(np.random.default_rng(2).standard_normal(1000).astype(np.float32))}
    err = init_error_feedback(g)
    gc, _ = compress_gradients(g, err, cfg)
    nz = int((gc["w"] != 0).sum())
    assert nz <= 110


def test_wire_bytes_model():
    params = {"w": torch.zeros(1000)}
    assert wire_bytes(params, CompressionConfig("none")) == 2000
    assert wire_bytes(params, CompressionConfig("int8")) == 1000
    assert wire_bytes(params, CompressionConfig("topk", topk_ratio=0.01)) == 80


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(5), "nested": {"b": torch.ones((2, 3))}}
    for step in (1, 2, 3):
        mgr.save(step, tree_map(lambda x: x * step, tree))
    assert mgr.all_steps() == [2, 3]  # keep=2 garbage-collected step 1
    restored, step = mgr.restore(tree)
    assert step == 3
    np.testing.assert_array_equal(_np(restored["a"]), np.arange(5) * 3)
    np.testing.assert_array_equal(_np(restored["nested"]["b"]), np.ones((2, 3)) * 3)


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp dir from a crashed writer must not be visible."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_0000000009.tmp")
    mgr.save(1, {"x": torch.zeros(2)})
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(5, {"x": torch.arange(10)})
    mgr.wait()
    restored, step = mgr.restore({"x": torch.zeros(10, dtype=torch.int32)})
    assert step == 5


def test_plan_remesh_preserves_model_axis():
    plan = plan_remesh(240, model_parallel=16)
    assert plan.mesh_shape == (15, 16)
    assert plan.n_devices == 240
    with pytest.raises(RuntimeError):
        plan_remesh(8, model_parallel=16)


def test_build_mesh_from_plan_single_device():
    plan = plan_remesh(1, model_parallel=1)
    with test_torch_common.one_rank_group():
        mesh = build_mesh_from_plan(plan, device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="process group"):
        build_mesh_from_plan(plan, device="cpu")


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=2.0, window=16, policy="flag")
    for _ in range(10):
        mon.step_start()
        mon._t0 -= 0.01  # simulate 10ms steps
        assert mon.step_end() is None
    mon.step_start()
    mon._t0 -= 0.2      # simulate a 200ms straggler step
    assert mon.step_end() == "flag"
    assert len(mon.flagged) == 1


# ---------------------------------------------------------------------------
# the same inputs through both packages: functions
# ---------------------------------------------------------------------------

def test_warmup_cosine_matches_jax_in_float32():
    for args in ((3e-3, 5, 40), (1.0, 10, 100), (0.1, 1, 1)):
        j, t = jopt.warmup_cosine(*args), warmup_cosine(*args)
        for step in range(0, args[2] + 3):
            assert t(step) == pytest.approx(float(j(jnp.int32(step))), rel=1e-6, abs=0), \
                (args, step)


def test_int8_and_topk_match_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((3, 40, 7)) * np.array([1e-3, 1.0, 30.0])[:, None, None]
         ).astype(np.float32)
    e = (rng.standard_normal(g.shape) * 1e-3).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(g))
    tq, ts = quantize_int8(_t(g))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    assert float(ts) == float(js)
    for kind, ratio in (("int8", 0.01), ("topk", 0.05), ("topk", 1e-4)):
        jg, je = jcomp.compress_gradients({"w": jnp.asarray(g)}, {"w": jnp.asarray(e)},
                                          jcomp.CompressionConfig(kind, ratio))
        tg, te = compress_gradients({"w": _t(g)}, {"w": _t(e)}, CompressionConfig(kind, ratio))
        np.testing.assert_array_equal(_np(tg["w"]) != 0, np.asarray(jg["w"]) != 0)
        np.testing.assert_allclose(_np(tg["w"]), np.asarray(jg["w"]), **FN_TOL)
        np.testing.assert_allclose(_np(te["w"]), np.asarray(je["w"]), **FN_TOL)
    assert wire_bytes({"w": _t(g)}, CompressionConfig("topk", 0.05)) == \
        jcomp.wire_bytes({"w": jnp.asarray(g)}, jcomp.CompressionConfig("topk", 0.05))


def _grad_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_optimizer_updates_match_jax(kind):
    """Three updates from the same parameters and gradients; Adafactor on a
    factored and an unfactored leaf."""
    shapes = {"big": (2, 128, 256), "small": (4, 6), "vec": (5,)}
    params = _grad_tree(shapes, 0)
    jo, to = jopt.make_optimizer(kind, 1e-2), topt.make_optimizer(kind, 1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _grad_tree(shapes, step + 1)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp, step)
        tp2, ts2 = to.update({k: _t(v) for k, v in grads.items()}, ts, tp, step)
        assert tp2 is tp and ts2 is ts  # in place
        for (key, a), (_, b) in zip(tree_items(tp), tree_items(jp)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        for (key, a), (_, b) in zip(tree_items(ts), tree_items(js)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-6, atol=1e-12,
                                       err_msg=key)


def test_optimizer_updates_in_place_and_step_is_a_host_int():
    """Deliberate differences (ROADMAP Queue 3): the update writes the
    parameters and the state in place, and the train state's step is a host
    int (checkpointed as an int32 scalar, as the reference's step array)."""
    loss, params = _quadratic_problem()
    w = params["w"]
    opt = adamw(0.1)
    step = make_train_step(loss, opt, TrainConfig())
    state = init_train_state(params, opt, TrainConfig())
    m = state["opt"]["m"]["w"]
    new_params, new_state, _ = step(params, state, {})
    assert new_params["w"] is w and new_state["opt"]["m"]["w"] is m
    assert float(w.abs().sum()) > 0 and float(m.abs().sum()) > 0
    assert state["step"] == 0 and new_state["step"] == 1
    assert isinstance(new_state["step"], int)


def test_state_axes_match_jax():
    for kind in ("adamw", "adafactor", "sgd"):
        jcfg = jget("mistral-large-123b").cfg
        tcfg = tget("mistral-large-123b").cfg
        want = jopt.state_axes(kind, jtf.param_axes(jcfg), jtf.param_shapes(jcfg))
        got = state_axes(kind, ttf.param_axes(tcfg), ttf.param_shapes(tcfg))
        assert got == want


# ---------------------------------------------------------------------------
# whole train steps on carried weights
# ---------------------------------------------------------------------------

STACKED = dict(name="stacked", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
               d_ff=256, vocab=256, q_chunk=16, kv_chunk=16)


def _steppers(jcfg, tcfg, kind, tc_kw, seed=0):
    jtc = jts.TrainConfig(**{k: (jcomp.CompressionConfig(*v) if k == "compression" else v)
                             for k, v in tc_kw.items()})
    ttc = TrainConfig(**{k: (CompressionConfig(*v) if k == "compression" else v)
                         for k, v in tc_kw.items()})
    jo, to = jopt.make_optimizer(kind, LR), topt.make_optimizer(kind, LR)
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    model = ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    jstep = jax.jit(jts.make_train_step(lambda p, b: jtf.loss_fn(p, b, jcfg), jo, jtc))
    tstep = make_train_step(lambda p, b: ttf.loss_fn(model, b), to, ttc)
    return (params, jts.init_train_state(params, jo, jtc), jstep), \
        (model, init_train_state(model.params, to, ttc), tstep)


def _batches(vocab, n, seed=1):
    it = JCorpus(vocab, seed=0).batches(4, 32, seed=seed)
    return [next(it) for _ in range(n)]


def _params_close(tparams, jparams, share_within: float, lr_bound: bool = True):
    """Every entry within 2.5 LR (when ``lr_bound``) and all but ``share_within``
    of the entries within 1e-5 of the leaf's largest value."""
    off = total = 0
    for (key, a), (_, b) in zip(tree_items(tparams), tree_items(jparams)):
        a, b = _np(a).astype(np.float64), np.asarray(b, np.float64)
        d = np.abs(a - b)
        if lr_bound:
            assert d.max() <= 2.5 * LR, (key, d.max() / LR)
        off += int((d > 1e-5 * np.abs(b).max()).sum())
        total += d.size
    assert off <= share_within * total, (off, total)


def _run_both(jside, tside, batches, gn_rtol=1e-4, share=1e-4, lr_bound=True):
    (jp, jst, jstep), (model, tst, tstep) = jside, tside
    tp = model.params
    for b in batches:
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        tp, tst, tm = tstep(tp, tst, {k: torch.as_tensor(v) for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=gn_rtol)
        _params_close(tp, jp, share, lr_bound)
    return jp, jst, tp, tst


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b", "mistral-large-123b",
                                  "kimi-k2-1t-a32b"])
def test_train_step_matches_jax_on_smoke_configs(arch):
    """Three steps of each family's own optimizer (adamw; adafactor for
    mistral and kimi) from the reference's weights."""
    js, ts = jget(arch), tget(arch)
    assert ts.optimizer_kind == js.optimizer_kind
    jside, tside = _steppers(js.smoke_cfg, ts.smoke_cfg, js.optimizer_kind, {})
    _run_both(jside, tside, _batches(js.smoke_cfg.vocab, 3))


def test_train_step_microbatches_match_jax():
    js, ts = jget("smollm-135m"), tget("smollm-135m")
    jside, tside = _steppers(js.smoke_cfg, ts.smoke_cfg, "adamw", {"microbatches": 2})
    _run_both(jside, tside, _batches(js.smoke_cfg.vocab, 3))


def _stacked_cfgs():
    return (jtf.LMConfig(**STACKED, dtype=jnp.float32),
            ttf.LMConfig(**STACKED, dtype=torch.float32))


@pytest.mark.parametrize("kind", ["adafactor", "int8", "topk"])
def test_stacked_leaf_statistics_match_jax(kind):
    """Statistics taken over a whole leaf span every layer, as in the
    reference: Adafactor's factoring test and update clip, int8's absmax,
    top-k's threshold.  Two layers at d_model 128 / d_ff 256 (so Adafactor
    factors the stacked [L, 128, 256] leaves), layer 1's gradients 100x
    layer 0's so that per-layer statistics would differ."""
    jcfg, tcfg = _stacked_cfgs()
    shapes = jtf.param_shapes(jcfg)
    rng = np.random.default_rng(7)
    grads = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * np.where(
            np.arange(s.shape[0]) == 1, 100.0, 1.0).reshape((-1,) + (1,) * (len(s.shape) - 1))
            if len(s.shape) > 1 and s.shape[0] == 2 else rng.standard_normal(s.shape)
        ).astype(np.float32), shapes)
    w3 = grads["layers"]["w_gate"]
    assert np.abs(w3[0]).max() < np.abs(w3).max() / 10  # per layer would differ
    if kind == "adafactor":
        params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        model = ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        jo, to = jopt.adafactor(1e-2), topt.adafactor(1e-2)
        js, ts = jo.init(params), to.init(model.params)
        assert ts["layers"]["w_gate"]["vr"].shape == (2, 128)
        assert "v" in ts["layers"]["wq"]  # [2, 128, 4, 32]: last two dims (4, 32)
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, grads), js, params, 0)
        to.update(tree_map(_t, grads), ts, model.params, 0)
        for (key, a), (_, b) in zip(tree_items(model.params), tree_items(jp)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        return
    cfg = (kind, 0.01)
    err = jax.tree_util.tree_map(np.zeros_like, grads)
    jg, _ = jcomp.compress_gradients(jax.tree_util.tree_map(jnp.asarray, grads),
                                     jax.tree_util.tree_map(jnp.asarray, err),
                                     jcomp.CompressionConfig(*cfg))
    tg, _ = compress_gradients(tree_map(_t, grads), tree_map(_t, err), CompressionConfig(*cfg))
    for (key, a), (_, b) in zip(tree_items(tg), tree_items(jg)):
        np.testing.assert_array_equal(_np(a) != 0, np.asarray(b) != 0, err_msg=key)
        np.testing.assert_allclose(_np(a), np.asarray(b), **FN_TOL, err_msg=key)
    if kind == "topk":  # layer 0 of w_gate keeps nothing: the threshold is the leaf's
        assert not _np(tg["layers"]["w_gate"][0]).any()


@pytest.mark.parametrize("compression", ["none", "int8", "topk"])
def test_train_step_stacked_leaves_match_jax(compression):
    """Adafactor with each compression on the stacked configuration, two
    steps (module docstring: compressed steps are held by the loss, the
    gradient norm and all but 1% of the entries)."""
    jcfg, tcfg = _stacked_cfgs()
    tc = {} if compression == "none" else {"compression": (compression, 0.01)}
    jside, tside = _steppers(jcfg, tcfg, "adafactor", tc)
    _run_both(jside, tside, _batches(jcfg.vocab, 2), gn_rtol=1e-3,
              share=1e-2, lr_bound=compression == "none")


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    """Two reference steps, saved by the reference's manager; the port
    restores them (same bits) and both take a third step on the same batch."""
    js, ts = jget("smollm-135m"), tget("smollm-135m")
    (jp, jst, jstep), (model, tst, tstep) = _steppers(js.smoke_cfg, ts.smoke_cfg, "adamw", {})
    b1, b2, b3 = _batches(js.smoke_cfg.vocab, 3)
    for b in (b1, b2):
        jp, jst, _ = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
    JCheckpointManager(str(tmp_path)).save(2, {"params": jp, "state": jst})
    restored, step = CheckpointManager(str(tmp_path)).restore(
        {"params": model.params, "state": tst})
    assert step == 2 and restored["state"]["step"] == 2
    for (key, a), (_, b) in zip(tree_items(restored), tree_items({"params": jp, "state": jst})):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=key)
    with torch.no_grad():
        tree_map(lambda p, r: p.copy_(r), model.params, restored["params"])
    jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b3.items()})
    tp, tst, tm = tstep(model.params, restored["state"], {k: torch.as_tensor(v)
                                                           for k, v in b3.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _params_close(tp, jp, 1e-4)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    js, ts = jget("qwen3-moe-30b-a3b"), tget("qwen3-moe-30b-a3b")
    (jp, jst, jstep), (model, tst, tstep) = _steppers(js.smoke_cfg, ts.smoke_cfg, "adamw", {})
    b1, b2, b3 = _batches(js.smoke_cfg.vocab, 3)
    tp = model.params
    for b in (b1, b2):
        tp, tst, _ = tstep(tp, tst, {k: torch.as_tensor(v) for k, v in b.items()})
    CheckpointManager(str(tmp_path)).save(2, {"params": tp, "state": tst})
    restored, step = JCheckpointManager(str(tmp_path)).restore({"params": jp, "state": jst})
    assert step == 2 and int(restored["state"]["step"]) == 2
    assert restored["state"]["step"].dtype == jnp.int32
    for (key, a), (_, b) in zip(tree_items({"params": tp, "state": tst}), tree_items(restored)):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=key)
    jp, jst, jm = jstep(restored["params"], restored["state"],
                        {k: jnp.asarray(v) for k, v in b3.items()})
    tp, tst, tm = tstep(tp, tst, {k: torch.as_tensor(v) for k, v in b3.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _params_close(tp, jp, 1e-4)


def test_checkpoint_bfloat16_leaves(tmp_path):
    """The reference writes bfloat16 through ml_dtypes (2-byte voids), the
    port as uint16, both under manifest dtype "bfloat16"; the port reads
    both back as the same bits.  (The reference cannot restore either:
    ``jnp.asarray`` refuses the void array; ROADMAP Queue 3.)"""
    bits = np.random.default_rng(0).integers(0, 2**15, (3, 5)).astype(np.uint16)
    jleaf = jnp.asarray(bits.view(jnp.bfloat16))
    JCheckpointManager(str(tmp_path / "j")).save(1, {"w": jleaf})
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    CheckpointManager(str(tmp_path / "t")).save(1, {"w": t})
    for d in ("j", "t"):
        got, _ = CheckpointManager(str(tmp_path / d)).restore({"w": t})
        assert got["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["w"].view(torch.uint16).numpy(), bits)
        with open(tmp_path / d / "step_0000000001" / "manifest.json") as f:
            assert '"dtype": "bfloat16"' in f.read()
    with pytest.raises(TypeError):
        JCheckpointManager(str(tmp_path / "j")).restore({"w": jleaf})


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_runs_on_the_cpu_and_its_loss_falls(capsys):
    losses = launch_train.main(["--device", "cpu", "--scale", "smoke", "--steps", "20",
                                "--log-every", "5"])
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.5
    out = capsys.readouterr().out
    assert "arch=smollm-135m scale=smoke params=" in out
    assert "step     0 loss" in out and "final loss" in out and "median step" in out


def test_trainer_resume_sees_the_uninterrupted_batches(tmp_path):
    """Deliberate difference (ROADMAP Queue 3): a resumed run skips the
    batches of the steps it restored, so its losses equal the uninterrupted
    run's (the reference restarts the corpus at its first batch)."""
    argv = ["--device", "cpu", "--steps", "8", "--ckpt-every", "4", "--log-every", "100"]
    a = launch_train.main(argv + ["--ckpt", str(tmp_path / "a"), "--compression", "int8"])
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_0000000004", tmp_path / "b" / "step_0000000004")
    b = launch_train.main(argv + ["--ckpt", str(tmp_path / "b"), "--resume",
                                  "--compression", "int8"])
    assert b == a[4:]
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [4, 8]


# ---------------------------------------------------------------------------
# sharded training at world size 1 (multi-rank: test_torch_sharded_train.py)
# ---------------------------------------------------------------------------

def _one_rank_mesh():
    from repro_torch.distributed import make_mesh

    return make_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_sharded_state_takes_the_state_axes_placements(kind):
    """The optimizer state of DTensor parameters is built with the
    placements ``state_axes`` gives (Adafactor's row and column moments: the
    parameter's less the reduced dimension)."""
    from repro_torch.distributed.sharding import distribute_tree, spec_tree_sharding

    cfg = ttf.LMConfig(dtype=torch.float32, **STACKED)
    model = ttf.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    with test_torch_common.one_rank_group():
        mesh = _one_rank_mesh()
        axes = ttf.param_axes(cfg)
        state = make_optimizer(kind, LR).init(distribute_tree(model.params, axes, mesh))
        want = spec_tree_sharding(state_axes(kind, axes, ttf.param_shapes(cfg)), state, mesh)
        pairs = list(zip(tree_items(state), tree_items(want)))
        assert pairs
        for (key, leaf), (_, (m, pl)) in pairs:
            assert m is mesh and tuple(leaf.placements) == tuple(pl), key
        if kind == "adafactor":
            assert {k.rsplit("/", 1)[-1] for k, _ in tree_items(state)} >= {"vr", "vc"}


@pytest.mark.parametrize("kind,compression,micro", [
    ("adamw", "none", 1), ("adafactor", "none", 1), ("sgd", "none", 1),
    ("adafactor", "int8", 1), ("adamw", "topk", 1), ("adamw", "none", 2),
])
def test_sharded_step_at_world_size_one_equals_the_unsharded_step(kind, compression, micro):
    """Two steps of the stacked configuration with DTensor parameters and
    state on a (1, 1) mesh against the same steps on plain tensors: the step,
    the clip, each optimizer's in-place update, compression and microbatches
    run on DTensor leaves and give the plain step's numbers bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import distribute_tree, use_mesh

    cfg = ttf.LMConfig(dtype=torch.float32, **STACKED)
    tc = TrainConfig(microbatches=micro, compression=CompressionConfig(kind=compression))
    batches = _batches(cfg.vocab, 2)
    out = []
    with test_torch_common.one_rank_group():
        mesh = _one_rank_mesh()
        for sharded in (False, True):
            model = ttf.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
            if sharded:
                model = ttf.LM(cfg, distribute_tree(model.params, ttf.param_axes(cfg), mesh))
            opt = make_optimizer(kind, LR)
            step = make_train_step(lambda p, b: ttf.loss_fn(model, b), opt, tc)
            params, state, metrics = model.params, init_train_state(model.params, opt, tc), []
            for b in batches:
                with use_mesh(mesh if sharded else None):
                    params, state, m = step(params, state,
                                            {k: torch.as_tensor(v) for k, v in b.items()})
                # the metrics reach the caller as plain tensors
                assert not any(isinstance(v, DTensor) for v in m.values())
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            full = [_np(p.full_tensor() if sharded else p) for p in tree_leaves(params)]
            out.append((metrics, full, state["step"]))
    (m0, p0, s0), (m1, p1, s1) = out
    assert m1 == m0 and s1 == s0 == 2
    assert all(np.array_equal(a, b) for a, b in zip(p0, p1))


def test_checkpoint_restore_with_shardings(tmp_path):
    """A DTensor tree saves the same bytes as its plain values, and
    ``restore(shardings=)`` places every tensor leaf as asked (int leaves
    stay ints), onto other placements than the saved ones."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    plain = {"w": torch.arange(12.0).reshape(4, 3), "b": torch.ones(3, dtype=torch.bfloat16),
             "n": 7}
    with test_torch_common.one_rank_group():
        mesh = _one_rank_mesh()
        tree = {"w": distribute_tensor(plain["w"], mesh, [Shard(0), Shard(1)]),
                "b": distribute_tensor(plain["b"], mesh, [Replicate(), Shard(0)]), "n": 7}
        CheckpointManager(str(tmp_path / "sharded")).save(3, tree)
        CheckpointManager(str(tmp_path / "plain")).save(3, plain)
        shardings = {"w": (mesh, [Replicate(), Shard(1)]), "b": None, "n": None}
        got, step = CheckpointManager(str(tmp_path / "sharded")).restore(
            plain, shardings=shardings)
    assert step == 3 and got["n"] == 7
    assert isinstance(got["w"], DTensor) and got["w"].placements == (Replicate(), Shard(1))
    assert torch.equal(got["w"].to_local(), plain["w"])
    assert not isinstance(got["b"], DTensor) and torch.equal(got["b"], plain["b"])
    d1, d2 = (tmp_path / k / "step_0000000003" for k in ("sharded", "plain"))
    assert sorted(os.listdir(d1)) == sorted(os.listdir(d2))
    for name in os.listdir(d1):
        assert (d1 / name).read_bytes() == (d2 / name).read_bytes(), name
