"""GCN [arXiv:1609.02907]: 2L hidden=16, mean aggregation, sym norm."""

from ..models.gnn import GNNConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = GNNConfig(name="gcn-cora", model="gcn", n_layers=2, d_hidden=16,
                    n_classes=7, d_feat=1433)
    return ArchSpec(arch_id="gcn-cora", family="gnn", config=cfg,
                    source="arXiv:1609.02907")
