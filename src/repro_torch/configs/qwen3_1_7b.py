"""qwen3-1.7b [hf:Qwen/Qwen3-8B family]. qk_norm, GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
Pure full attention -> long_500k skipped.
"""

from ..models.transformer import LMConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_head=128, d_ff=6144, vocab=151936,
        qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
        act="silu",
    )
    return ArchSpec(
        arch_id="qwen3-1.7b", family="lm", config=cfg,
        skip_shapes={"long_500k": "pure full-attention arch; 512k decode "
                                  "requires sub-quadratic attention state"},
        source="hf:Qwen/Qwen3-8B",
        microbatches=2)
