"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M]: llama-arch dense 30L
d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings."""
import torch

from repro_torch.configs.base import register
from repro_torch.configs.families import LMFamily
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
    d_ff=1536, vocab=49152, rope_theta=1e4, tie_embeddings=True,
)

SMOKE = LMConfig(
    name="smollm-smoke",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=3, d_head=16,
    d_ff=96, vocab=128, dtype=torch.float32, q_chunk=16, kv_chunk=16,
    tie_embeddings=True,
)


@register("smollm-135m")
def _build():
    return LMFamily(
        "smollm-135m", CFG, SMOKE,
        source="hf:HuggingFaceTB/SmolLM-135M [hf]", optimizer="adamw",
    )
