"""Wide&Deep [arXiv:1606.07792]: 40 sparse fields, embed 32, MLP 1024-512-256."""

from ..models.recsys import RecsysConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = RecsysConfig(name="wide-deep", n_sparse=40, embed_dim=32,
                       vocab_per_field=1_000_000, n_dense=13,
                       mlp_dims=(1024, 512, 256), nnz_per_field=4,
                       n_candidates=1_000_000, retrieval_dim=256)
    return ArchSpec(arch_id="wide-deep", family="recsys", config=cfg,
                    source="arXiv:1606.07792")
