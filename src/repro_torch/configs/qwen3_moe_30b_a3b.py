"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d_model=2048 32H (GQA kv=4)
expert d_ff=768, vocab=151936, MoE 128 experts top-8."""
import torch

from repro_torch.configs.base import register
from repro_torch.configs.families import LMFamily
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=0, vocab=151936, rope_theta=1e6, use_qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
    # no activation recompute, as the reference's config (d_model 2048
    # leaves activation headroom at 1M tokens a pod)
    remat=False,
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=0, vocab=128, use_qk_norm=True, dtype=torch.float32,
    q_chunk=16, kv_chunk=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32),
)


@register("qwen3-moe-30b-a3b")
def _build():
    return LMFamily(
        "qwen3-moe-30b-a3b", CFG, SMOKE,
        source="hf:Qwen/Qwen3-30B-A3B [hf]", optimizer="adamw",
    )
