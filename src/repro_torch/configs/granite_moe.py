"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
Pure full attention -> long_500k skipped.
"""

from ..models.transformer import LMConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_head=64, d_ff=512, vocab=49155,
        n_experts=32, top_k=8, tie_embeddings=True, act="silu",
    )
    return ArchSpec(
        arch_id="granite-moe-1b-a400m", family="lm", config=cfg,
        skip_shapes={"long_500k": "pure full-attention arch; 512k decode "
                                  "requires sub-quadratic attention state"},
        source="hf:ibm-granite/granite-3.0-1b-a400m-base")
