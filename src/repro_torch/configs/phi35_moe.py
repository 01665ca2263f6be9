"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
Pure full attention -> long_500k skipped (noted in DESIGN.md / EXPERIMENTS).
"""

from ..models.transformer import LMConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=6400, vocab=32064,
        n_experts=16, top_k=2, qk_norm=False, tie_embeddings=False,
        rope_theta=10_000.0, act="silu", q_chunk=256,
    )
    return ArchSpec(
        arch_id="phi3.5-moe-42b-a6.6b", family="lm", config=cfg,
        skip_shapes={"long_500k": "pure full-attention arch; 512k decode "
                                  "requires sub-quadratic attention state"},
        source="hf:microsoft/Phi-3.5-MoE-instruct")
