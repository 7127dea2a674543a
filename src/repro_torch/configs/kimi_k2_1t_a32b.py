"""kimi-k2-1t-a32b [arXiv:2501.kimi2, paper-table/unverified]: 61L
d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840, MoE 384e top-8.
1 shared expert (DeepSeek-style).  Optimizer: Adafactor — Adam's fp32 state
for 1T params does not fit a 256-chip pod (DESIGN.md §5)."""
import torch

from repro_torch.configs.base import register
from repro_torch.configs.families import LMFamily
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=112,
    d_ff=0, vocab=163840, rope_theta=1e6,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1),
)

SMOKE = LMConfig(
    name="kimi-k2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=0, vocab=128, dtype=torch.float32, q_chunk=16, kv_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1),
)


@register("kimi-k2-1t-a32b")
def _build():
    return LMFamily(
        "kimi-k2-1t-a32b", CFG, SMOKE,
        source="arXiv:2501.kimi2 [paper-table; unverified]",
        optimizer="adafactor",
    )
