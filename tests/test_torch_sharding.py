"""The port's logical-axis rules (``repro_torch.distributed.sharding``):
``test_distributed.py``'s four ``logical_spec`` tests, with the port's
specs equal to the reference's ``PartitionSpec``s, and ``constrain`` /
``gather_fsdp``: the identity outside a mesh and under a mesh of axis
sizes only, DTensor redistributions under a ``DeviceMesh`` (here a one-rank
gloo group; multi-rank meshes are in ``test_torch_sharded_train.py``); the
placements of every parameter leaf of every sharded arch against the
reference's ``PartitionSpec`` on the production meshes and (4, 2), and the
parameter-axes tables against the reference's."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_torch_common
from repro.configs import get_arch as jget
from repro.distributed.sharding import AxisRules as JRules
from repro.distributed.sharding import DEFAULT_RULES as JDEFAULT
from repro.distributed.sharding import logical_spec as jlogical_spec
from repro.models import gnn as jgnn
from repro.models import mind as jmind
from repro.models import transformer as jtf
from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import (
    AxisRules,
    DEFAULT_RULES,
    constrain,
    current_mesh,
    gather_fsdp,
    logical_spec,
    named_sharding,
    placements,
    spec_tree_sharding,
    use_mesh,
)
from repro_torch.models import gnn as tgnn
from repro_torch.models import mind as tmind
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_items

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}
# the archs with a parameter-axes table (NequIP's dry run replicates all)
SHARDED_ARCHS = [a for a in ASSIGNED if a != "nequip"]


def test_logical_spec_no_mesh_is_fully_specified():
    spec = logical_spec((16, 32), ("batch", "mlp"))
    assert spec == P(("pod", "data"), "model")
    assert spec == jlogical_spec((16, 32), ("batch", "mlp"))


def test_divisibility_fallback():
    with test_torch_common.one_rank_group():
        mesh = make_mesh((1,), ("model",), device="cpu")
        # 9 heads on a model axis of size 1 -> trivially divisible
        spec = logical_spec((9,), ("heads",), mesh=mesh)
        assert spec == P("model")
    # a model axis of 4 does not divide 9 heads: replicated
    assert logical_spec((9, 8), ("heads", "mlp"), mesh={"model": 4}) == P(None, "model")


def test_missing_mesh_axes_dropped():
    with test_torch_common.one_rank_group():
        mesh = make_mesh((1,), ("data",), device="cpu")
        spec = logical_spec((8, 4), ("batch", "heads"), mesh=mesh)
        # "pod" and "model" absent from mesh -> reduced/replicated
        assert spec == P("data", None)


def test_unknown_axis_raises():
    with pytest.raises(KeyError):
        logical_spec((4,), ("nonsense",))


def test_rules_override_and_constrain_under_a_mesh():
    x = torch.ones(4, 6)
    assert constrain(x, "batch", "mlp") is x and gather_fsdp(x, "fsdp", None) is x
    assert current_mesh() is None
    rules = {"seq": "model", "fsdp": ("data", "model")}
    with use_mesh({"data": 2, "model": 2}, rules=rules):
        assert current_mesh() == {"data": 2, "model": 2}
        assert logical_spec((4, 6), ("seq", "fsdp")) == ("model", ("data", "model"))[:1] + \
            (None,)  # 6 is not a multiple of 4
        # a mesh of axis sizes has no devices to place on
        assert constrain(x, "batch", "mlp") is x
        assert gather_fsdp(x, "fsdp", "mlp") is x
    assert current_mesh() is None
    assert logical_spec((4,), ("seq",)) == (None,)
    assert AxisRules(DEFAULT_RULES).resolve("experts") == "model"
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with test_torch_common.one_rank_group():
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        with use_mesh(mesh):
            y = constrain(x, "batch", "mlp")
            assert isinstance(y, DTensor) and y.placements == (Shard(0), Shard(1))
            # a plain tensor under a mesh is taken as replicated on it
            r = constrain(x, None, None)
            assert isinstance(r, DTensor) and r.placements == (Replicate(), Replicate())
            assert torch.equal(r.full_tensor(), x) and torch.equal(y.full_tensor(), x)
            # a DTensor is redistributed; gather_fsdp drops the fsdp dimension
            w = constrain(x, "fsdp", "mlp")
            assert w.placements == (Shard(0), Shard(1))
            g = gather_fsdp(w, "fsdp", "mlp")
            assert g.placements == (Replicate(), Shard(1))
            assert torch.equal(g.full_tensor(), x)


@pytest.mark.parametrize("sizes,axes,shape,want", [
    ({"data": 16, "model": 16}, ("fsdp", "heads", None), (576, 9, 64), ("S(0)", "R")),
    ({"data": 16, "model": 16}, ("fsdp", "heads", None), (4096, 32, 128), ("S(0)", "S(1)")),
    ({"pod": 2, "data": 16, "model": 16}, ("batch", "seq"), (256, 4096), ("S(0)", "S(0)", "R")),
    ({"data": 4, "model": 2}, ("vocab", None), (49152, 576), ("R", "S(0)")),
    ({"data": 4, "model": 2}, ("layers", "fsdp", "mlp"), (30, 576, 1536), ("S(1)", "S(2)")),
    # a dimension of size 1 stays replicated, even where its axis divides it
    ({"data": 1, "model": 1}, ("moe_groups", "experts", None), (1, 8, 64), ("R", "S(1)")),
])
def test_placements_follow_the_spec(sizes, axes, shape, want):
    """One placement per mesh dimension: ``Shard(d)`` where dimension d maps
    there (``batch`` on both ``pod`` and ``data``), ``Replicate()`` where
    nothing does or the mesh size does not divide (smollm's 9 heads)."""
    got = placements(shape, axes, sizes)
    assert tuple("R" if p.is_replicate() else f"S({p.dim})" for p in got) == want


def test_named_and_tree_shardings():
    assert named_sharding((4, 6), ("batch", "mlp")) is None  # no mesh
    sizes = {"data": 2, "model": 3}
    mesh, pl = named_sharding((4, 6), ("batch", "mlp"), sizes)
    assert mesh is sizes and [p.dim for p in pl] == [0, 1]
    tree = spec_tree_sharding({"w": ("fsdp", "mlp"), "layers": [("heads",)], "s": ()},
                              {"w": (4, 6), "layers": [torch.empty(5)], "s": ()}, sizes)
    assert [p.dim for p in tree["w"][1]] == [0, 1]
    assert all(p.is_replicate() for p in tree["layers"][0][1])  # 3 does not divide 5
    assert all(p.is_replicate() for p in tree["s"][1])
    with pytest.raises(ValueError, match="shards two dimensions"):
        placements((6, 6), ("heads", "mlp"), sizes)


# ---------------------------------------------------------------------------
# placements and the parameter-axes tables
# ---------------------------------------------------------------------------

def _jmesh(sizes):
    """What the reference's ``logical_spec`` reads of a mesh, with no devices."""
    return SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values()), np.int8))


def _meta(shapes):
    """The reference's shape tree as meta tensors (no memory)."""
    return jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)


def _tables(arch):
    """(leaf shapes, port axes, reference axes, rules) of every parameter
    table the reference's dry run shards the arch by."""
    fam, jfam = get_arch(arch), jget(arch)
    if fam.family == "lm":
        shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), jtf.param_shapes(jfam.cfg))
        yield shapes, ttf.param_axes(fam.cfg), jtf.param_axes(jfam.cfg), fam.rules_override
    elif fam.family == "gnn":
        for cell in fam.cells:
            jcfg = jfam._cfg(jfam.cells[cell])
            shapes = jax.eval_shape(lambda: jgnn.init_gnn(jax.random.PRNGKey(0), jcfg))
            yield (jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes),
                   tgnn.gnn_param_axes(_meta(shapes)), jgnn.gnn_param_axes(shapes), None)
    else:
        shapes = jax.eval_shape(lambda: jmind.init_mind(jax.random.PRNGKey(0), jfam.cfg))
        yield ({k: tuple(v.shape) for k, v in shapes.items()},
               tmind.mind_param_axes(_meta(shapes)), jmind.mind_param_axes(shapes), None)


def _pairs(port, ref):
    """(path, port leaf, reference leaf) of two trees of axes tuples."""
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    flat, _ = jax.tree_util.tree_flatten_with_path(ref, is_leaf=is_leaf)
    for path, leaf in flat:
        node = port
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        yield jax.tree_util.keystr(path), node, leaf


@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_param_axes_tables_equal_jax(arch):
    for shapes, port, ref, _ in _tables(arch):
        pairs = list(_pairs(port, ref))
        assert pairs and all(p == r for _, p, r in pairs), \
            [(k, p, r) for k, p, r in pairs if p != r]
        assert len(list(tree_items(port))) == len(pairs)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_placements_agree_with_the_reference_spec(arch, mesh):
    """For every leaf: the port's spec equals the reference's
    ``PartitionSpec`` (under the family's rules), and ``placements`` shards
    dimension d over exactly the mesh axes the spec names for it."""
    sizes = MESHES[mesh]
    names = list(sizes)
    for shapes, port, ref, rules in _tables(arch):
        prules, jrules = AxisRules({**DEFAULT_RULES, **(rules or {})}), \
            JRules({**JDEFAULT, **(rules or {})})
        for key, pax, jax_ in _pairs(port, ref):
            shape = _lookup(shapes, key)
            spec = jlogical_spec(shape, jax_, _jmesh(sizes), jrules)
            assert logical_spec(shape, pax, sizes, prules) == tuple(spec), key
            want = ["R"] * len(names)
            for d, axes in enumerate(spec):
                for a in ((axes,) if isinstance(axes, str) else axes or ()):
                    want[names.index(a)] = f"S({d})"
            got = placements(shape, pax, sizes, prules)
            assert ["R" if p.is_replicate() else f"S({p.dim})" for p in got] == want, key


def _lookup(shapes, keystr):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    return dict((jax.tree_util.keystr(p), v) for p, v in flat)[keystr]


def test_production_meshes_need_a_group_of_their_size():
    """``launch/mesh.py``: the production meshes are (16, 16) and
    (2, 16, 16); like every mesh they cover the whole process group."""
    from repro_torch.launch.mesh import make_mesh as launch_mesh
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with test_torch_common.one_rank_group():
        with pytest.raises(ValueError, match="512 ranks but the process group has 1"):
            make_production_mesh(multi_pod=True, device="cpu")
        mesh = launch_mesh((1, 1), ("data", "model"), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
