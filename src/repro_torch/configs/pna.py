"""PNA [arXiv:2004.05718]: 4L hidden=75, mean/max/min/std x id/amp/atten."""

from ..models.gnn import GNNConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = GNNConfig(name="pna", model="pna", n_layers=4, d_hidden=75,
                    n_classes=16)
    return ArchSpec(arch_id="pna", family="gnn", config=cfg,
                    source="arXiv:2004.05718")
