"""phi4-mini-3.8b [arXiv:2412.08905, hf]: dense 32L d_model=3072 24H
(GQA kv=8) d_ff=8192 vocab=200064; RoPE + SwiGLU + GQA."""
import torch

from repro_torch.configs.base import register
from repro_torch.configs.families import LMFamily
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="phi4-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=200064, rope_theta=1e4,
    # no activation recompute, as the reference's config (3.8B parameters
    # leave activation headroom at 1M tokens a pod)
    remat=False,
)

SMOKE = LMConfig(
    name="phi4-mini-smoke",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_head=12,
    d_ff=128, vocab=128, dtype=torch.float32, q_chunk=16, kv_chunk=16,
)


@register("phi4-mini-3.8b")
def _build():
    return LMFamily(
        "phi4-mini-3.8b", CFG, SMOKE,
        source="arXiv:2412.08905 [hf]", optimizer="adamw",
    )
