"""graphsage-reddit [arXiv:1706.02216]: 2 layers, d_hidden=128, mean
aggregator, fanout neighbor sampling (data/samplers.py)."""
from repro_torch.configs.base import register
from repro_torch.configs.families import GNNFamily


@register("graphsage-reddit")
def _build():
    return GNNFamily(
        "graphsage-reddit", arch="graphsage", n_layers=2, d_hidden=128,
        source="arXiv:1706.02216 [paper]", aggregator="mean",
    )
