"""gcn-cora [arXiv:1609.02907]: 2-layer GCN, d_hidden=16, symmetric
normalization, mean aggregation."""
from repro_torch.configs.base import register
from repro_torch.configs.families import GNNFamily


@register("gcn-cora")
def _build():
    return GNNFamily(
        "gcn-cora", arch="gcn", n_layers=2, d_hidden=16,
        source="arXiv:1609.02907 [paper]", aggregator="mean",
    )
