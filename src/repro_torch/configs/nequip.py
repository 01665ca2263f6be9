"""NequIP [arXiv:2101.03164]: 5L hidden=32, l_max=2, n_rbf=8, cutoff=5.

O(3)-equivariant interatomic potential; irreps in the Cartesian tensor
basis (see DESIGN.md hardware-adaptation notes).
"""

from ..models.gnn import GNNConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = GNNConfig(name="nequip", model="nequip", n_layers=5, d_hidden=32,
                    l_max=2, n_rbf=8, cutoff=5.0, n_species=16)
    return ArchSpec(arch_id="nequip", family="gnn", config=cfg,
                    source="arXiv:2101.03164")
