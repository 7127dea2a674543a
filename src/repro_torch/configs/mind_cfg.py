"""mind [arXiv:1904.08030, unverified]: embed_dim=64, 4 interests, 3 capsule
routing iterations, multi-interest interaction.  Item table sized for an
industrial catalogue (1e8 rows)."""
from repro_torch.configs.base import register
from repro_torch.configs.families import RecsysFamily
from repro_torch.models.mind import MINDConfig

CFG = MINDConfig(
    name="mind", n_items=100_000_000, embed_dim=64, n_interests=4,
    capsule_iters=3, hist_len=50, n_negatives=1024,
)


@register("mind")
def _build():
    return RecsysFamily("mind", CFG, source="arXiv:1904.08030 [unverified]")
