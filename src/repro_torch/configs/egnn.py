"""EGNN [arXiv:2102.09844]: 4L hidden=64, E(n)-equivariant."""

from ..models.gnn import GNNConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = GNNConfig(name="egnn", model="egnn", n_layers=4, d_hidden=64,
                    n_species=16)
    return ArchSpec(arch_id="egnn", family="gnn", config=cfg,
                    source="arXiv:2102.09844")
