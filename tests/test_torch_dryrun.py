"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.dryrun``), and the pieces it rests on.

The reference's dry run sets ``XLA_FLAGS`` to 512 devices in ``os.environ``
on import, so it runs only in a subprocess here; the port's runs on a fake
process group, so it runs in a subprocess too (a group made in an xdist
worker would outlive this file).  Both run once per module, side by side
(the port's 32k-token prefill in a process of its own), over the cells
below; each test then reads their records.

Per cell the port's record equals the reference's in status, skip reason,
device count, mesh shape and axis names and model FLOPs; its per-device
argument bytes equal the reference's to the byte, except by one rule: a
train cell's optimizer step is a host int in the port (ROADMAP Queue 3), so
its arguments are the reference's less the reference's int32 step.  The
port runs with a card's memory given, so every ``ok`` record answers
``fits``.  The wire model is the reference's
``parse_collectives``.  FLOPs are rank 0's own: a product sharded over a
fake (2, 2) mesh counts a quarter of its global FLOPs, a replicated one all
of them, and a (1, 1) mesh counts the unsharded step's.  ``remat`` leaves a
train step's loss and gradients bit for bit as they were.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_map

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

# (arch, shape, mesh) of every compared cell
CELLS = ([("smollm-135m", s, "single")
          for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
         + [("gcn-cora", "full_graph_sm", "single"), ("mind", "serve_p99", "single")]
         + [("kairos", s, "single") for s in ("ea_scan_1b", "ea_selective_1b",
                                             "ea_sparse_1b", "ea_selsparse_1b",
                                             "cc_1b", "pagerank_1b")]
         + [("kairos", "ea_selective_1b", "multi")]
         + [("nequip", "molecule", m) for m in ("single", "multi")])
HBM_BYTES = 80 * 2**30

# one synthetic post-SPMD HLO line per collective kind, and its (op, result
# bytes, group size)
HLO_LINES = [
    ("%ar = f32[1024,8]{1,0} all-reduce(f32[1024,8]{1,0} %x), replica_groups={{0,1,2,3}}",
     "all-reduce", 1024 * 8 * 4, 4),
    ("%ag = bf16[64,128]{1,0} all-gather(bf16[4,128]{1,0} %x), replica_groups=[16,16]<=[256]",
     "all-gather", 64 * 128 * 2, 16),
    ("%rs = f32[32]{0} reduce-scatter(f32[512]{0} %x), replica_groups={{0,1,2,3,4,5,6,7}}",
     "reduce-scatter", 32 * 4, 8),
    ("%a2a = s32[16,16]{1,0} all-to-all(s32[16,16]{1,0} %x), replica_groups=[32,16]<=[512]",
     "all-to-all", 16 * 16 * 4, 16),
    ("%cp = f32[8,8]{1,0} collective-permute(f32[8,8]{1,0} %x), source_target_pairs={{0,1}}",
     "collective-permute", 8 * 8 * 4, 1),
]

_REFERENCE = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun
    out, cells = sys.argv[1], json.loads(sys.argv[2])
    for arch, shape, mesh in cells:
        dryrun.run_cell(arch, shape, mesh, out)
    wire = [dryrun.parse_collectives(line)[0] for line, *_ in json.loads(sys.argv[3])]
    json.dump(wire, open(out + "/wire.json", "w"))
""")

_PORT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    out, cells, hbm_bytes = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
    for mesh in ("single", "multi"):
        for arch, shape, m in cells:
            if m == mesh:
                dryrun.run_cell(arch, shape, mesh, out, hbm_bytes=hbm_bytes)
""")


def _run(code, *args, env=None):
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{"ref" | "port": {(arch, shape, mesh): record}}, and the reference's
    parsed HLO lines under "wire"."""
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("ref", "port")}
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    # the port's longest cell (a 32k-token prefill) runs beside its others
    long = [c for c in CELLS if c[1] == "prefill_32k"]
    procs = {"ref": _run(_REFERENCE, dirs["ref"], json.dumps(CELLS), json.dumps(HLO_LINES),
                         env=env),
             "port": _run(_PORT, dirs["port"], json.dumps([c for c in CELLS if c not in long]),
                          str(HBM_BYTES), env=env),
             "port, long": _run(_PORT, dirs["port"], json.dumps(long), str(HBM_BYTES),
                                env=env)}
    for name, p in procs.items():
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, f"{name}:\n{out[-4000:]}"
    recs = {name: {(a, s, m): json.load(open(os.path.join(d, f"{a}__{s}__{m}.json")))
                   for a, s, m in CELLS} for name, d in dirs.items()}
    recs["wire"] = json.load(open(os.path.join(dirs["ref"], "wire.json")))
    return recs


def test_list_equals_reference(capsys):
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--list"], env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert dryrun.main(["--list"]) == 0
    port = capsys.readouterr().out
    parse = lambda text: [line.split(" -> ") for line in text.strip().splitlines()]  # noqa: E731
    assert parse(port) == parse(ref.stdout)


@pytest.mark.parametrize("cell", CELLS, ids=["__".join(c) for c in CELLS])
def test_record_equals_reference(records, cell):
    ref, port = records["ref"][cell], records["port"][cell]
    keys = ("status", "skip_reason", "n_devices", "mesh_shape", "axis_names", "kind",
            "model_flops_global")
    assert {k: port.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    if ref["status"] == "skipped":
        return
    step = 4 if ref["kind"] == "train" else 0    # the reference's int32 step
    assert port["memory"]["argument_size_in_bytes"] == \
        ref["memory"]["argument_size_in_bytes"] - step
    assert port["collective_wire_bytes_per_device"] >= 0
    assert port["memory"]["peak_memory_in_bytes"] >= port["memory"]["argument_size_in_bytes"]


def test_nequip_shards_its_edges(records):
    """NequIP's records are the production program's: no ``deviation``, a
    boolean ``fits`` against the card's memory, and its edges sharded over
    ``("pod", "data")``, so a rank holds fewer argument bytes on two pods
    than on one."""
    args = {}
    for mesh in ("single", "multi"):
        port = records["port"][("nequip", "molecule", mesh)]
        assert port["status"] == "ok" and "deviation" not in port
        assert port["memory"]["hbm_bytes"] == HBM_BYTES
        assert isinstance(port["memory"]["fits"], bool)
        args[mesh] = port["memory"]["argument_size_in_bytes"]
    assert args["multi"] < args["single"]
    assert all("deviation" not in rec for rec in records["port"].values())


def test_kairos_collectives_equal_reference(records):
    """The Kairos rounds' collectives are the reference's, kind by kind,
    except PageRank's sum, whose partials travel in float64 (ROADMAP
    Queue 3): twice the reference's bytes."""
    for cell in CELLS:
        if cell[0] != "kairos":
            continue
        ref, port = records["ref"][cell]["collectives"], records["port"][cell]["collectives"]
        scale = 2 if cell[1] == "pagerank_1b" else 1
        assert {k: (v["count"], v["payload_bytes"]) for k, v in port.items()} == \
            {k: (v["count"], scale * v["payload_bytes"]) for k, v in ref.items()}, cell


def test_wire_model_equals_reference(records):
    for (_, kind, payload, k), ref in zip(HLO_LINES, records["wire"]):
        assert (ref["op"], ref["payload_bytes"], ref["group_size"]) == (kind, payload, k)
        assert dryrun.wire_bytes(kind, payload, k) == ref["wire_bytes"]


@pytest.fixture
def fake_group():
    """A fake process group of 4 ranks in this process, destroyed after."""
    assert not dist.is_initialized()
    dryrun._fake_group(4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_flops_are_the_ranks_own(fake_group):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    m, k, n = 64, 32, 16
    a, b = torch.empty(m, k, device="meta"), torch.empty(k, n, device="meta")
    for pa, pb, share in (((Shard(0), Replicate()), (Replicate(), Shard(1)), 4),
                          ((Replicate(), Replicate()), (Replicate(), Replicate()), 1)):
        args = (distribute_tensor(a, mesh, pa), distribute_tensor(b, mesh, pb))
        with dryrun.StepCounter(args) as counter:
            out = args[0] @ args[1]
        assert counter.flops * share == 2 * m * k * n
        assert tuple(out.shape) == (m, n) and not counter.collectives


def _smoke_train(cfg, params, mesh=None):
    """A train step of the smollm family on ``params`` (a tree of tensors);
    with ``mesh`` the parameters, state and batch are placed on it."""
    from repro_torch.configs.families import _dry_train_args, _meta

    fam = get_arch("smollm-135m")
    tokens = {"tokens": _meta((2, 32), torch.int32), "labels": _meta((2, 32), torch.int32)}
    axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if mesh is None:
        model = tf.LM(cfg, params)
        opt, step = fam.train_objects(model)
        from repro_torch.train.train_step import TrainConfig, init_train_state

        return step, (model.params, init_train_state(model.params, opt, TrainConfig()),
                      tokens)
    p, state, batch = _dry_train_args(params, tf.param_axes(cfg), fam.optimizer_kind,
                                      fam.optimizer(), tokens, axes, mesh)
    model = tf.LM(cfg, p)
    return fam.train_objects(model, mesh)[1], (model.params, state, batch)


def _meta_params(cfg):
    return tree_map(lambda s: torch.empty(s, dtype=cfg.dtype, device="meta"),
                    tf.param_shapes(cfg))


def test_one_rank_mesh_counts_the_unsharded_step():
    """At mesh (1, 1) the smollm smoke step counts exactly the FLOPs of the
    unsharded meta step, and the meta step those of the CPU step (both run
    the 4 x 2 attention tiles)."""
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_arch("smollm-135m").smoke_cfg, q_chunk=8, kv_chunk=16)
    flops = {}
    for name in ("cpu", "meta", "mesh"):
        if name == "cpu":
            gen = torch.Generator().manual_seed(0)
            params = tf.init_lm(cfg, gen, "cpu").params
            step, args = _smoke_train(cfg, tree_map(lambda p: p.detach().clone(), params))
            toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen, dtype=torch.int32)
            args = (args[0], args[1], {"tokens": toks, "labels": toks})
        elif name == "meta":
            step, args = _smoke_train(cfg, _meta_params(cfg))
        else:
            dryrun._fake_group(1)
            try:
                step, args = _smoke_train(cfg, _meta_params(cfg),
                                          make_mesh((1, 1), ("data", "model"), device="cpu"))
                with dryrun.StepCounter(args) as counter:
                    step(*args)
            finally:
                dist.destroy_process_group()
            flops[name] = counter.flops
            continue
        with dryrun.StepCounter(args) as counter:
            step(*args)
        flops[name] = counter.flops
    assert flops["cpu"] > 0
    assert flops["mesh"] == flops["meta"] == flops["cpu"]


def test_remat_leaves_loss_and_gradients_bit_identical():
    fam = get_arch("smollm-135m")
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(fam.smoke_cfg, remat=remat)
        gen = torch.Generator().manual_seed(0)
        model = tf.init_lm(cfg, gen, "cpu")
        toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
        loss, _ = tf.loss_fn(model, {"tokens": toks, "labels": toks})
        out[remat] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert get_arch("smollm-135m").cfg.remat
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))


def test_dry_attention_caps_tile_steps_at_equal_flops():
    """The dry run's attention (``_dry_attention``) widens the kv chunk by
    the least multiple that leaves at most 64 tile steps a layer, keeps a
    config that already does, and leaves the step's FLOPs as the configured
    chunks give them."""
    from repro_torch.configs import families

    base = get_arch("smollm-135m").smoke_cfg
    cfg = dataclasses.replace(base, q_chunk=2, kv_chunk=2)
    wide = families._dry_attention(cfg, 32)
    assert (wide.q_chunk, wide.kv_chunk) == (2, 8)      # 16 x 4 tiles, not 16 x 16
    few = dataclasses.replace(base, q_chunk=8, kv_chunk=4)
    assert families._dry_attention(few, 32) is few      # 4 x 8 tiles
    assert families._dry_attention(dataclasses.replace(cfg, kv_chunk=6), 36).kv_chunk == 12
    flops = []
    for c in (cfg, wide):
        step, args = _smoke_train(c, _meta_params(c))
        with dryrun.StepCounter(args) as counter:
            step(*args)
        flops.append(counter.flops)
    assert flops[0] == flops[1] > 0


def _traced(fn, *leaves):
    """``fn()``'s result and the aten ops its forward and backward run."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    ops = []
    with Ops():
        out = fn()
        grads = torch.autograd.grad(out.float().square().sum(), leaves)
    return out, grads, ops


def test_products_without_a_mesh_are_the_plain_matmuls():
    """With no mesh the MLP, the attention projections and the head run
    the plain ``@`` expressions: the same aten ops, forward and backward,
    and the same bits (the shard-by-shard routes are the DTensors' only)."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(0)
    cfg = get_arch("smollm-135m").smoke_cfg
    model = tf.init_lm(cfg, gen, "cpu")
    B, S, d, f, H, Dh = 2, 8, cfg.d_model, cfg.d_ff, 4, 4

    def leaf(*shape):
        return torch.randn(shape, generator=gen, requires_grad=True)

    x, wg, wu, wd = leaf(B, S, d), leaf(d, f), leaf(d, f), leaf(f, d)
    wq, wo, attn = leaf(d, H, Dh), leaf(H, Dh, d), leaf(B, S, H, Dh)
    h = leaf(B, S, d)
    assert cfg.tie_embeddings                    # the head is the embedding's transpose
    cases = [
        (lambda: layers.swiglu(x, wg, wu, wd),
         lambda: (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd, (x, wg, wu, wd)),
        (lambda: tf._proj(x, wq),
         lambda: (x @ wq.reshape(d, -1)).reshape(B, S, H, Dh), (x, wq)),
        (lambda: tf._out_proj(attn, wo),
         lambda: attn.reshape(B, S, -1) @ wo.reshape(-1, d), (attn, wo)),
        (lambda: tf._logits(model, h),
         lambda: (layers.rms_norm(h, model.final_ln) @ model.embed.T.to(h.dtype)).float(),
         (h,)),
    ]
    for got_fn, want_fn, leaves in cases:
        got, want = _traced(got_fn, *leaves), _traced(want_fn, *leaves)
        assert got[2] == want[2]
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
