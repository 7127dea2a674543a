"""The paper's own cells (``repro_torch.configs.kairos``) against the JAX
package's: ``KAIROS_CELLS`` equal, ``model_flops`` equal for every cell,
the cells' plans equal to the ones the reference's ``lowerable`` builds,
and ``KairosFamily.smoke`` (the distributed EA on a one-rank gloo group
against ``earliest_arrival``) passing and equal to the reference's."""
import dataclasses

import pytest

import test_torch_common  # noqa: F401  (one intra-op thread per worker)
from repro.configs import get_arch as jget
from repro.configs.kairos import KAIROS_CELLS as JCELLS
from repro.engine.plan import make_plan as jmake_plan
from repro_torch.configs import get_arch
from repro_torch.configs.kairos import KAIROS_CELLS, KairosFamily, cell_plan
from test_torch_common import one_rank_group


def test_kairos_cells_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in KAIROS_CELLS.items()} == \
        {k: dataclasses.astuple(v) for k, v in JCELLS.items()}
    assert len(KAIROS_CELLS) == 6


def test_kairos_family_equal_jax():
    j, t = jget("kairos"), get_arch("kairos")
    assert isinstance(t, KairosFamily)
    assert (t.arch_id, t.family, t.source) == (j.arch_id, j.family, j.source)
    for cell in t.cells:
        assert t.model_flops(cell) == j.model_flops(cell)


@pytest.mark.parametrize("cell", [c for c in KAIROS_CELLS if c.startswith("ea")])
def test_cell_plans_equal_the_references(cell):
    """The access string maps onto the round's two flags as in the
    reference's ``lowerable``."""
    m = JCELLS[cell].meta
    want = jmake_plan(
        "index" if m["access"] in ("index", "selsparse") else "scan",
        budget=m.get("budget_per_shard", 0) if m["access"] in ("index", "selsparse") else 0,
        exchange_budget=m.get("exchange_budget", 0)
        if m["access"] in ("sparse", "selsparse") else 0,
    )
    got = cell_plan(KAIROS_CELLS[cell])
    assert (got.method, got.budget, got.exchange_budget) == \
        (want.method, want.budget, want.exchange_budget)
    assert got.cache_key == want.cache_key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kairos_smoke_on_one_gloo_rank(seed):
    """The smoke run opens (and closes) its own one-rank gloo group, and
    runs inside a caller's group too; both match the single-device engine,
    as the reference's smoke does."""
    want = jget("kairos").smoke(seed=seed)
    assert want == {"matches_single_device": True, "finite": True}
    assert get_arch("kairos").smoke(seed=seed, device="cpu") == want
    with one_rank_group():
        assert get_arch("kairos").smoke(seed=seed, device="cpu") == want
