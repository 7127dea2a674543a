"""The spawn harness and the rank bodies of the port's multi-process tests
(no test functions here).

This module imports no JAX, so a spawned rank starts in about a second: the
ranks run the port on gloo CPU process groups and pickle what they computed
to a file; the test process, which imports JAX, holds it against the JAX
package.  Every spawn has a timeout, so a hang fails its test instead of
eating the suite's time limit.
"""
import hashlib
import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp

SPAWN_TIMEOUT = 240.0


def _rank_main(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.distributed import init_process_group

    init_process_group("cpu", init_method=f"file://{tmp}/store", world_size=world,
                       rank=rank)
    out = fn(rank, *args)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    # no rank tears its connections down while another still reads them
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, timeout=SPAWN_TIMEOUT):
    """Run ``fn(rank, *args)`` in ``world`` spawned gloo ranks; returns the
    list of their results in rank order.  A rank that raises fails the call
    (the others are terminated); so does a run past ``timeout`` seconds."""
    tmp = str(tmp_path)
    ctx = mp.start_processes(_rank_main, args=(fn, world, tmp, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def digest(arrays) -> str:
    """A hash of nested tuples / lists of arrays (ranks compare their rows
    to rank 0's without shipping them all)."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        else:
            a = np.ascontiguousarray(x)
            h.update(str(a.dtype).encode() + str(a.shape).encode())
            h.update(a.tobytes())

    walk(arrays)
    return h.hexdigest()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the distributed engine (tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------

ENGINE_GRAPH = dict(n_vertices=90, n_edges=2500, seed=13)
ENGINE_SOURCES = (0, 1, 2, 3)
ENGINE_ROUNDS = 60
PR_ROUNDS = 20


def engine_case():
    """The port's graph and window of the reference engine test."""
    from repro_torch.data.generators import power_law_temporal_graph

    g = power_law_temporal_graph(**ENGINE_GRAPH, device="cpu")
    ts = _np(g.t_start)
    win = (int(np.quantile(ts, 0.4)), int(_np(g.t_end).max()))
    return g, win


def pagerank_inputs(src, ts, te, win, n_vertices):
    """The inverse window out-degree (0 where none) a PageRank round takes."""
    ok = (ts >= win[0]) & (te <= win[1])
    deg = np.bincount(src[ok], minlength=n_vertices).astype(np.float32)
    return np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0).astype(np.float32)


def engine_ranks(rank, mesh_shape):
    """Every distributed-engine result on a ``("data", "model")`` mesh."""
    from repro_torch.core.edgemap import INT_INF
    from repro_torch.distributed import graph_engine as ge
    from repro_torch.distributed import make_mesh
    from repro_torch.engine.plan import make_plan

    mesh = make_mesh(mesh_shape, ("data", "model"))
    g, win = engine_case()
    V, S = g.n_vertices, len(ENGINE_SOURCES)
    arr0 = torch.full((S, V), INT_INF, dtype=torch.int32)
    arr0[torch.arange(S), torch.tensor(ENGINE_SOURCES)] = win[0]
    edges = ge.shard_edges(mesh, g.src, g.dst, g.t_start, g.t_end)
    evalid = ge.shard_edges(mesh, torch.ones(g.n_edges, dtype=torch.bool))[0]
    sorted_ = ge.sort_edges_by_time_per_shard(mesh, g.src, g.dst, g.t_start, g.t_end)
    out = {}
    for name, plan, sort in (
            ("scan", None, False),
            ("index", make_plan("index", budget=1024), True),
            ("topk8", make_plan("scan", exchange_budget=8), False),
            ("topk64", make_plan("scan", exchange_budget=64), False),
            ("index_topk8", make_plan("index", budget=1024, exchange_budget=8), True)):
        e_arrays = sorted_[:4] if sort else edges
        e_valid = sorted_[4] if sort else evalid
        res, rounds = ge.run_distributed_ea(
            mesh, arr0, e_arrays, e_valid, win, max_rounds=ENGINE_ROUNDS, plan=plan,
            edges_time_sorted=sort, with_rounds=True)
        out[f"ea_{name}"] = (_np(res), rounds)
    src, ts, te = _np(g.src), _np(g.t_start), _np(g.t_end)
    inv = torch.from_numpy(pagerank_inputs(src, ts, te, win, V))
    pr_round = ge.make_pagerank_round(mesh, V)
    pr = torch.full((V,), 1.0 / V, dtype=torch.float32)
    prs = []
    for _ in range(PR_ROUNDS):
        pr = pr_round(pr, *edges, evalid, inv, win)
        prs.append(_np(pr))
    out["pagerank"] = np.stack(prs)
    cc_round = ge.make_cc_round(mesh, V)
    labels = torch.arange(V, dtype=torch.int32)
    cc = [_np(labels)]
    for _ in range(ENGINE_ROUNDS):
        new = cc_round(labels, *edges, evalid, win)
        cc.append(_np(new))
        if torch.equal(new, labels):
            break
        labels = new
    out["cc"] = np.stack(cc)
    return out


# ---------------------------------------------------------------------------
# sharded serving (tests/test_torch_sharded_serving.py)
# ---------------------------------------------------------------------------

SERVE_GRAPH = dict(n_vertices=200, n_edges=5000, seed=8)
MIXED_ALGS = ("earliest_arrival", "reachability", "bfs", "cc", "pagerank")
# past two ring wraps of the reference's soak (64 / 48 advances there)
SOAK_STEPS = 24
CHURN_STEPS = 16
TILED_STEPS = 4
BOUNDARY_CASES = (("exact-base", 31, 32, 20), ("straddle", 24, 16, 24))


def serve_case(gen_module, build_tger, **device):
    """The reference soak's graph and index, with its width and stride:
    ``(g, idx, t_max, width, stride)``."""
    g = gen_module.power_law_temporal_graph(**SERVE_GRAPH, **device)
    idx = build_tger(g, degree_cutoff=48)
    ts = _np(g.t_start)
    span = int(ts.max() - ts.min())
    return g, idx, int(_np(g.t_end).max()), max(span // 100, 1), max(span // 400, 1)


def mixed_batch(engine, base, width, stride, n=16, dup=2):
    """The reference soak's 5-algorithm batch plus ``dup`` duplicates,
    built with ``engine``'s QuerySpec / QueryBatch (either package)."""
    specs = []
    for i in range(n):
        alg = MIXED_ALGS[i % len(MIXED_ALGS)]
        off = (i % 2) * stride
        win = (int(base - off - width), int(base - off))
        if alg == "cc":
            specs.append(engine.QuerySpec.make(alg, win))
        elif alg == "pagerank":
            specs.append(engine.QuerySpec.make(alg, win, n_iters=8))
        else:
            specs.append(engine.QuerySpec.make(alg, win, sources=(3 * i) % 200))
    specs.extend(specs[:dup])
    return engine.QueryBatch.make(specs)


def boundary_case(temporal_graph, build_tger, **device):
    """The edge-shard boundary graph: t_start = arange(E), so time-first
    positions ARE times."""
    n_e, n_v = 4096, 64
    rng = np.random.default_rng(3)
    g = temporal_graph.from_edges(rng.integers(0, n_v, n_e), rng.integers(0, n_v, n_e),
                                  np.arange(n_e), n_vertices=n_v, rng=rng, **device)
    return g, build_tger(g, degree_cutoff=16)


def boundary_batch(engine, lo, width):
    return engine.QueryBatch.make([
        engine.QuerySpec.make("earliest_arrival", (lo, lo + width), sources=3),
        engine.QuerySpec.make("cc", (lo, lo + width)),
    ])


def snap(results):
    return [tuple(_np(x) for x in (r if isinstance(r, tuple) else (r,)))
            for r in results]


def serve_chain(serve_batch, dispatch_log, g, idx, batches, **kw):
    """Serve ``batches`` as one chain; per advance ``(rows, last_advance,
    dispatch tags, lo, hi, capacity)``."""
    state, out = None, []
    for batch in batches:
        with dispatch_log() as log:
            res, state = serve_batch(g, batch, idx, state=state, **kw)
        out.append((snap(res), state.last_advance, tuple(log), state.lo, state.hi,
                    state.capacity))
    return out


def _counting(module, name, counts):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **k)

    setattr(module, name, wrapped)


def serving_ranks(rank, meshes, boundary_meshes, bucketed_mesh=None, tiled_mesh=None):
    """Every sharded serving chain of one world size: the mixed soak at each
    of ``meshes`` (index), the boundary cases at ``boundary_meshes``, the
    bucketed churn at ``bucketed_mesh`` and a scan / pallas_tiled chain at
    ``tiled_mesh`` (K1's and K3's plain versions counted inside its
    advances).  Rank 0 returns the rows; every rank returns their digest."""
    import repro_torch.engine as te
    import repro_torch.engine.backends as backends
    from repro_torch.core import temporal_graph as ttg
    from repro_torch.core.tger import build_tger
    from repro_torch.data import generators
    from repro_torch.serve import dispatch_log, serve_batch

    g, idx, t_max, width, stride = serve_case(generators, build_tger, device="cpu")
    out = {}
    base0 = t_max - (SOAK_STEPS + 2) * stride
    soak = [mixed_batch(te, base0 + k * stride, width, stride)
            for k in range(SOAK_STEPS)]
    for mesh in meshes:
        out[("soak", mesh)] = serve_chain(serve_batch, dispatch_log, g, idx, soak,
                                          access="index", mesh=mesh)
    if bucketed_mesh is not None:
        churn = [mixed_batch(te, base0 + k * stride, width, stride, n=12 + k % 3)
                 for k in range(CHURN_STEPS)]
        out[("bucketed", bucketed_mesh)] = serve_chain(
            serve_batch, dispatch_log, g, idx, churn, access="index",
            mesh=bucketed_mesh, admission="bucketed")
    if tiled_mesh is not None:
        counts: dict = {}
        _counting(backends, "segment_min_tiles", counts)
        _counting(backends, "segment_spmm_tiles", counts)
        tiled, state = [], None
        for k in range(TILED_STEPS):
            counts.clear()
            with dispatch_log() as log:
                res, state = serve_batch(g, soak[k], idx, state=state, access="scan",
                                         backend="pallas_tiled", mesh=tiled_mesh)
            tiled.append((snap(res), state.last_advance, tuple(log), dict(counts)))
        out[("tiled", tiled_mesh)] = tiled
    for mesh in boundary_meshes:
        # the edge-sharded refusals, each before any state is consumed
        refused = []
        _, state = serve_batch(g, soak[0], idx, access="index", mesh=mesh)
        for kw in (dict(access="scan"), dict(tger=None),
                   dict(plan=te.make_plan("scan"))):
            args = dict(dict(access="index", tger=idx), **kw)
            try:
                serve_batch(g, soak[1], args.pop("tger"), state=state, mesh=mesh, **args)
            except ValueError as e:
                refused.append(str(e))
        out[("refusals", mesh)] = (refused, state.consumed)
    bg, bidx = boundary_case(ttg, build_tger, device="cpu")
    for name, w, s, steps in BOUNDARY_CASES:
        for mesh in boundary_meshes:
            out[("boundary", name, mesh)] = serve_chain(
                serve_batch, dispatch_log, bg, bidx,
                [boundary_batch(te, k * s, w) for k in range(steps)],
                access="index", mesh=mesh)
    digests = {k: digest([a[0] for a in v]) for k, v in out.items()
               if k[0] != "refusals"}
    return (out if rank == 0 else None), digests


# ---------------------------------------------------------------------------
# sharded training (tests/test_torch_sharded_train.py)
# ---------------------------------------------------------------------------

ELASTIC_ARCH = "smollm-135m"
ELASTIC_LR = 3e-3
ELASTIC_BATCH = (8, 32)


def elastic_batches(vocab, skip=0):
    """The reference e2e test's batches (MarkovCorpus seed 0, stream seed 1),
    past the first ``skip``."""
    from repro_torch.data.tokens import MarkovCorpus

    it = MarkovCorpus(vocab=vocab, seed=0).batches(*ELASTIC_BATCH, seed=1)
    for _ in range(skip):
        next(it)
    return it


def _lm_trainer(fam, model, mesh):
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step

    opt = make_optimizer("adamw", ELASTIC_LR)
    step = make_train_step(lambda p, b: tf.loss_fn(model, b), opt, TrainConfig())

    def run(params, state, batch):
        from repro_torch.distributed.sharding import use_mesh

        with use_mesh(mesh, rules=fam.rules_override):
            return step(params, state, batch)

    return opt, run, init_train_state(model.params, opt, TrainConfig())


def _steps(run, params, state, batches, n):
    losses, norms = [], []
    for _ in range(n):
        b = {k: torch.as_tensor(v) for k, v in next(batches).items()}
        params, state, m = run(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, state, losses, norms


def _full_params(params):
    """Every rank gathers (a collective); the numpy tree of the whole values."""
    from repro_torch.distributed.sharding import full_value
    from repro_torch.tree import tree_map

    return tree_map(lambda p: _np(full_value(p.detach())), params)


def elastic_first(rank, carried, ckpt, mesh_shape, n_steps):
    """Train the carried weights ``n_steps`` on ``mesh_shape`` and save the
    sharded params and state at step ``n_steps``."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import CheckpointManager

    fam = get_arch(ELASTIC_ARCH)
    mesh = make_mesh(mesh_shape, ("data", "model"))
    model = fam.shard(tf.params_from_numpy(carried, fam.smoke_cfg, "cpu"), mesh)
    _, run, state = _lm_trainer(fam, model, mesh)
    placements = {k: tuple(map(str, p.placements))
                  for k, p in (("wq", model.params["layers"]["wq"]),
                               ("embed", model.params["embed"]),
                               ("m/wq", state["opt"]["m"]["layers"]["wq"]))}
    params, state, losses, norms = _steps(run, model.params, state,
                                          elastic_batches(fam.smoke_cfg.vocab), n_steps)
    CheckpointManager(ckpt).save(n_steps, {"params": params, "state": state})
    return {"losses": losses, "norms": norms, "params": _full_params(params),
            "placements": placements}


def elastic_resume(rank, ckpt, n_surviving, model_parallel, n_steps):
    """Plan the re-mesh for the survivors, restore onto it and go on."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import spec_tree_sharding
    from repro_torch.models import transformer as tf
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.elastic import build_mesh_from_plan, plan_remesh
    from repro_torch.train.optimizer import state_axes

    fam = get_arch(ELASTIC_ARCH)
    cfg = fam.smoke_cfg
    plan = plan_remesh(n_surviving, model_parallel=model_parallel)
    mesh = build_mesh_from_plan(plan, device="cpu")
    axes, shapes = tf.param_axes(cfg), tf.param_shapes(cfg)
    template = tf.init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    _, _, tmpl_state = _lm_trainer(fam, template, None)
    shardings = {"params": spec_tree_sharding(axes, shapes, mesh),
                 "state": {"opt": spec_tree_sharding(state_axes("adamw", axes, shapes),
                                                     {"m": shapes, "v": shapes}, mesh),
                           "step": None}}
    restored, step0 = CheckpointManager(ckpt).restore(
        {"params": template.params, "state": tmpl_state}, shardings=shardings)
    model = tf.LM(cfg, restored["params"])
    _, run, _ = _lm_trainer(fam, model, mesh)
    state = restored["state"]
    wq = model.params["layers"]["wq"]
    params, state, losses, norms = _steps(run, model.params, state,
                                          elastic_batches(cfg.vocab, skip=step0), n_steps)
    return {"plan": plan.note, "step0": step0, "losses": losses, "norms": norms,
            "mesh": tuple(mesh.shape), "wq_placements": tuple(map(str, wq.placements)),
            "state_step": state["step"], "params": _full_params(params)}


SHARDED_STEP_CASES = ("qwen3-moe-30b-a3b", "mistral-large-123b", "gcn-cora", "mind")


def _case(arch, mesh):
    """(build, optimizer, batch, rules) of one case's reduced config: build(
    mesh) -> (params, loss(params, batch)) from seed 0, the params placed as
    DTensors by their logical axes when ``mesh`` is given."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.models import gnn, mind
    from repro_torch.models import transformer as tf

    fam = get_arch(arch)
    rng = np.random.default_rng(0)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    if fam.family == "lm":
        cfg = fam.mesh_cfg(fam.smoke_cfg, mesh)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 32)))

        def build(m):
            model = tf.init_lm(cfg, gen(), "cpu")
            if m is not None:
                model = fam.shard(model, m)
            return model.params, lambda p, b: tf.loss_fn(model, b)

        return build, fam.optimizer(), {"tokens": toks, "labels": toks}, fam.rules_override
    if fam.family == "gnn":
        cfg = fam.smoke_cfg()
        N, E = 40, 160
        batch = {"x": torch.as_tensor(rng.standard_normal((N, 6)), dtype=torch.float32),
                 "src": torch.as_tensor(rng.integers(0, N, E)),
                 "dst": torch.as_tensor(rng.integers(0, N, E)),
                 "labels": torch.as_tensor(rng.integers(0, 3, N))}
        init, axes = (lambda: gnn.init_gnn(cfg, gen(), "cpu")), gnn.gnn_param_axes
        loss = lambda p, b: (gnn.gnn_loss(p, b, cfg), {})  # noqa: E731
        opt = fam.train_objects("full_graph_sm")[0]
    else:
        cfg = fam.smoke_cfg()
        batch = {"hist": torch.as_tensor(rng.integers(0, 500, (4, 12))),
                 "target": torch.as_tensor(rng.integers(1, 500, (4,))),
                 "negatives": torch.as_tensor(rng.integers(1, 500, (4, 16)))}
        init, axes = (lambda: mind.init_mind(cfg, gen(), "cpu")), mind.mind_param_axes
        loss = lambda p, b: (mind.train_loss(p, b, cfg), {})  # noqa: E731
        opt = fam.train_objects(cfg)[0]

    def build(m):
        params = init()
        return (params if m is None else distribute_tree(params, axes(params), m)), loss

    return build, opt, batch, None


def sharded_step_ranks(rank, mesh_shape, cases):
    """One train step of each case, unsharded and on ``mesh_shape``, from the
    same weights and batch: both metrics, both parameter lists and the
    sharded leaves' placements."""
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    mesh = make_mesh(mesh_shape, ("data", "model"))
    out = {}
    for arch in cases:
        build, opt, batch, rules = _case(arch, mesh)
        got = []
        for m in (None, mesh):
            params, loss = build(m)
            step = make_train_step(loss, opt, TrainConfig())
            state = init_train_state(params, opt, TrainConfig())
            with use_mesh(m, rules=rules):
                params, state, metrics = step(params, state, dict(batch))
            got.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                        [_np(p) for p in tree_leaves(_full_params(params))],
                        sorted({str(tuple(map(str, p.placements)))
                                for p in tree_leaves(params) if m is not None})))
        (l0, g0, p0, _), (l1, g1, p1, pl) = got
        out[arch] = {"loss": (l0, l1), "grad_norm": (g0, g1), "params": (p0, p1),
                     "placements": pl}
    return out
