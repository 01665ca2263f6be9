"""The benchmark's own, frozen arithmetic: operations of the
served work, from the configuration's shapes alone, and the card's
published peaks. The program's own counters and dry run are not read
here, so a later change to the program cannot move this yardstick.

Operations count a multiply-add as two. A token's matrix work is twice the
parameters it multiplies by: the attention projections, the FFN (an MoE
layer's router and its ``top_k`` routed experts, not every expert, and not
the capacity padding), and the LM head over the published vocabulary.
Causal attention adds ``4 * heads * head_dim`` for every (query, visible
key) pair: the scores and the weighted sum.
"""

from __future__ import annotations

# Published dense peaks, by the name torch.cuda.get_device_name gives
# (NVIDIA's data sheets, SXM and PCIe parts): (bf16 FLOP/s, HBM bytes/s).
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
    "NVIDIA H100 NVL": (835e12, 3.9e12),
}


def peaks(kind: str) -> tuple[float, float] | None:
    """(bf16 FLOP/s, bytes/s) of a card by its name, None if not listed."""
    return PEAKS.get(kind)


def matmul_params(m) -> int:
    """Parameters a token multiplies by (``m``: a ``reference.Model``)."""
    d, H, Kh, dh = m.d, m.heads, m.kv_heads, m.head_dim
    attn = d * H * dh + 2 * d * Kh * dh + H * dh * d
    if m.experts:
        ffn = d * m.experts + m.top_k * 3 * d * m.ffn
    else:
        ffn = 3 * d * m.ffn
    return m.layers * (attn + ffn) + m.vocab * d


def attention_flops(m, pairs: int) -> int:
    """Operations of every layer's attention over ``pairs`` (query,
    visible key) pairs."""
    return 4 * m.layers * m.heads * m.head_dim * pairs


def causal_pairs(S: int) -> int:
    """(query, visible key) pairs of one causal prompt of S tokens."""
    return S * (S + 1) // 2


def prefill_flops(m, batch: int, S: int) -> int:
    """One prefill of ``batch`` prompts of S tokens."""
    return (2 * matmul_params(m) * batch * S
            + attention_flops(m, batch * causal_pairs(S)))


def flash_flops(m, batch: int, S: int) -> int:
    """One layer's prefill attention launch: its least operations."""
    return 4 * batch * m.heads * m.head_dim * causal_pairs(S)
