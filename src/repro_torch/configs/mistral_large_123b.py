"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407, unverified]:
dense 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
import torch

from repro_torch.configs.base import register
from repro_torch.configs.families import LMFamily
from repro_torch.models.transformer import LMConfig

CFG = LMConfig(
    name="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab=32768, rope_theta=1e6,
    # token-sharded layout (see TOKEN_SHARDED_RULES): q stays seq-sharded, so
    # q-chunking would scan over a sharded axis — disable it (nq=1).
    q_chunk=1 << 20,
)

# The reference's token-sharded rules (batch over data, sequence over model,
# full ZeRO-3 weight sharding over both axes), copied as data: sharded
# training is ROADMAP Queue 1 item 16.
TOKEN_SHARDED_RULES = {
    "seq": "model",
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "vocab": None,
    "fsdp": ("data", "model"),
}

SMOKE = LMConfig(
    name="mistral-large-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=160, vocab=128, dtype=torch.float32, q_chunk=16, kv_chunk=16,
)


@register("mistral-large-123b")
def _build():
    return LMFamily(
        "mistral-large-123b", CFG, SMOKE,
        source="hf:mistralai/Mistral-Large-Instruct-2407 [unverified]",
        optimizer="adafactor",  # 123B: factored state keeps the pod in HBM
        rules_override=TOKEN_SHARDED_RULES,
    )
