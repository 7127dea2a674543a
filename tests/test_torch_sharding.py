"""The port's logical-axis rules (``repro_torch.distributed.sharding``):
``test_distributed.py``'s four ``logical_spec`` tests, with the port's
specs equal to the reference's ``PartitionSpec``s, and ``constrain`` /
``gather_fsdp``: the identity outside a mesh, refused under one (sharded
training is ROADMAP Queue 1 item 16)."""
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_torch_common
from repro.distributed.sharding import logical_spec as jlogical_spec
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import (
    AxisRules,
    DEFAULT_RULES,
    constrain,
    current_mesh,
    gather_fsdp,
    logical_spec,
    use_mesh,
)


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
        with pytest.raises(NotImplementedError, match="item 16"):
            constrain(x, "batch", "mlp")
        with pytest.raises(NotImplementedError, match="item 16"):
            gather_fsdp(x, "fsdp", "mlp")
    assert current_mesh() is None
    assert logical_spec((4,), ("seq",)) == (None,)
    assert AxisRules(DEFAULT_RULES).resolve("experts") == "model"
