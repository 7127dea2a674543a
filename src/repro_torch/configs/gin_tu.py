"""gin-tu [arXiv:1810.00826]: GIN, 5 layers, d_hidden=64, sum aggregation,
learnable eps."""
from repro_torch.configs.base import register
from repro_torch.configs.families import GNNFamily


@register("gin-tu")
def _build():
    return GNNFamily(
        "gin-tu", arch="gin", n_layers=5, d_hidden=64,
        source="arXiv:1810.00826 [paper]", aggregator="sum",
    )
