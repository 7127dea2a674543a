"""Architecture registry: importing this package registers the LM configs."""
from repro_torch.configs.base import Cell, get_arch, list_archs  # noqa: F401
from repro_torch.configs.families import LM_CELLS, LMFamily  # noqa: F401
from repro_torch.configs import (  # noqa: F401
    kimi_k2_1t_a32b,
    mistral_large_123b,
    phi4_mini_3_8b,
    qwen3_moe_30b_a3b,
    smollm_135m,
)

# the reference's LM architectures (its ASSIGNED list also names the GNN,
# NequIP and RecSys configs: ROADMAP Queue 1 item 16)
ASSIGNED = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "mistral-large-123b",
            "smollm-135m", "phi4-mini-3.8b"]
