"""gemma2-2b [arXiv:2408.00118]. Local+global alternating, logit softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim=256,
sliding window 4096 on even layers, attn softcap 50, final softcap 30,
GeGLU, sandwich norms, sqrt(d) embedding scaling.

Hybrid local/global -> long_500k RUNS here (O(S) cache attention per step;
local layers bound the window).
"""

from ..models.transformer import LMConfig
from .registry import ArchSpec


def spec() -> ArchSpec:
    cfg = LMConfig(
        name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8,
        n_kv_heads=4, d_head=256, d_ff=9216, vocab=256000,
        attn_pattern="local_global", window=4096,
        attn_softcap=50.0, final_softcap=30.0, sandwich_norm=True,
        scale_embed=True, act="gelu", tie_embeddings=True,
    )
    return ArchSpec(arch_id="gemma2-2b", family="lm", config=cfg,
                    source="arXiv:2408.00118",
                    microbatches=4)
