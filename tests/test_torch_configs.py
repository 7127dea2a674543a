"""The port's LM configs (``repro_torch.configs``) against the JAX
package's: every LM architecture's published and reduced config field by
field, parameter counts, model FLOPs and shape cells equal; each reduced
config's smoke step finite on the CPU (``test_configs_smoke.py``'s tests,
for the LM architectures)."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.configs import get_arch as jget
from repro.configs.families import LM_CELLS as JLM_CELLS
from repro_torch.configs import ASSIGNED, LM_CELLS, get_arch, list_archs

SKIP_FIELDS = {"dtype", "moe", "remat", "unroll", "gather_weights"}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in SKIP_FIELDS}


@pytest.mark.parametrize("arch_id", ASSIGNED)
def test_configs_equal_jax(arch_id):
    j, t = jget(arch_id), get_arch(arch_id)
    assert (t.arch_id, t.family, t.source) == (j.arch_id, j.family, j.source)
    assert (t.optimizer_kind, t.opt_kw, t.microbatches, t.rules_override) == \
        (j.optimizer_kind, j.opt_kw, j.microbatches, j.rules_override)
    for tcfg, jcfg in ((t.cfg, j.cfg), (t.smoke_cfg, j.smoke_cfg)):
        assert _fields(tcfg) == {k: v for k, v in _fields(jcfg).items()
                                 if k in _fields(tcfg)}
        assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        assert (tcfg.moe is None) == (jcfg.moe is None)
        if tcfg.moe:
            assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
        assert tcfg.n_params == jcfg.n_params
        assert tcfg.n_active_params == jcfg.n_active_params
        assert tcfg.head_dim == jcfg.head_dim
    assert t.layer_count() == j.layer_count()
    for cell in LM_CELLS:
        assert t.model_flops(cell) == j.model_flops(cell)


def test_lm_cells_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in LM_CELLS.items()} == \
        {k: dataclasses.astuple(v) for k, v in JLM_CELLS.items()}


@pytest.mark.parametrize("arch_id", ASSIGNED)
def test_arch_smoke(arch_id):
    metrics = get_arch(arch_id).smoke(seed=0, device="cpu")
    finite_keys = [k for k in metrics if "finite" in k]
    assert finite_keys and all(metrics[k] for k in finite_keys), metrics
    assert torch.isfinite(torch.tensor(metrics["loss"]))
    assert metrics["decode_shape"] == (2, get_arch(arch_id).smoke_cfg.vocab)


def test_all_assigned_archs_registered():
    assert set(ASSIGNED) <= set(list_archs())


@pytest.mark.parametrize("arch_id", ASSIGNED)
def test_cells_defined(arch_id):
    spec = get_arch(arch_id)
    assert len(spec.cells) == 4, f"{arch_id} must define its 4 shape cells"
    for cell in spec.cells.values():
        assert cell.kind in ("train", "prefill", "decode", "serve", "retrieval", "analytics")


def test_lm_long_500k_skip_reason():
    cell = get_arch("smollm-135m").cells["long_500k"]
    assert cell.skip and "full-attention" in cell.skip
