"""Architecture registry: importing this package registers all configs."""
from repro_torch.configs.base import ArchSpec, Cell, get_arch, list_archs  # noqa: F401
from repro_torch.configs.families import (  # noqa: F401
    GNN_CELLS,
    LM_CELLS,
    RECSYS_CELLS,
    GNNFamily,
    LMFamily,
    NequIPFamily,
    RecsysFamily,
)
from repro_torch.configs.kairos import KAIROS_CELLS, KairosFamily  # noqa: F401

# assigned architectures (import -> register)
from repro_torch.configs import (  # noqa: F401
    gcn_cora,
    gin_tu,
    graphsage_reddit,
    kairos,
    kimi_k2_1t_a32b,
    mind_cfg,
    mistral_large_123b,
    nequip_cfg,
    phi4_mini_3_8b,
    qwen3_moe_30b_a3b,
    smollm_135m,
)

ASSIGNED = [
    "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "mistral-large-123b",
    "smollm-135m", "phi4-mini-3.8b",
    "gin-tu", "nequip", "gcn-cora", "graphsage-reddit",
    "mind",
]
