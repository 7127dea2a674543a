"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 Bessel RBF,
cutoff 5 A, E(3) tensor-product equivariance."""
from repro_torch.configs.base import register
from repro_torch.configs.families import NequIPFamily
from repro_torch.models.nequip import NequIPConfig

CFG = NequIPConfig(
    name="nequip", n_layers=5, d_hidden=32, l_max=2, n_rbf=8, cutoff=5.0,
    n_species=64,
)


@register("nequip")
def _build():
    return NequIPFamily("nequip", CFG, source="arXiv:2101.03164 [paper]")
