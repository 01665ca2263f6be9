"""The benchmark's frozen operation and byte counts against hand counts."""

import json

import pytest

import _tiny
from portbench import counts
from portbench.reference import Model

CONFIGS = _tiny.ROOT / "portbench" / "configs"


def model(name):
    return Model.from_config(json.loads((CONFIGS / f"{name}.json")
                                        .read_text()))


def test_qwen3_prefill_32k():
    m = model("qwen3-0.6b")
    # per layer: q 1024x2048, k and v 1024x1024, o 2048x1024, FFN 3x1024x3072
    per_layer = 2048 * 1024 * 3 + 3 * 1024 * 3072
    assert counts.matmul_params(m) == 28 * per_layer + 151936 * 1024
    total = counts.prefill_flops(m, 1, 32768)
    assert total == pytest.approx(162.2e12, rel=5e-4)
    head = 2 * 151936 * 1024 * 32768
    assert head == pytest.approx(10.2e12, rel=5e-3)
    assert counts.attention_flops(m, counts.causal_pairs(32768)) == \
        pytest.approx(123.1e12, rel=5e-4)
    # flash's least time a layer at 989 TFLOP/s: PERF's 4.447 ms
    bf16, _ = counts.peaks("NVIDIA H100 80GB HBM3")
    assert counts.flash_flops(m, 1, 32768) / bf16 * 1e3 == \
        pytest.approx(4.447, abs=5e-4)


def test_moe_prefill_counts_routed_experts_only():
    """granite-moe-1b-a400m's shapes (24 layers, d 1,024, 16/8 heads of
    64, 32 experts of 512, top 8, vocab 49,155) at B 8 x 4,096: 34.7
    TFLOP."""
    m = Model.from_config(dict(
        _tiny.MOE, hidden_size=1024, intermediate_size=512,
        num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=8,
        num_local_experts=32, num_experts_per_tok=8, vocab_size=49155))
    attn = 1024 * 1024 * 2 + 2 * 1024 * 512
    ffn = 1024 * 32 + 8 * 3 * 1024 * 512
    assert counts.matmul_params(m) == 24 * (attn + ffn) + 49155 * 1024
    assert counts.prefill_flops(m, 8, 4096) == pytest.approx(34.7e12,
                                                             rel=2e-3)


def test_qwen3_prefill_4k_batch():
    m = model("qwen3-0.6b")
    one = counts.prefill_flops(m, 1, 4096)
    assert counts.prefill_flops(m, 8, 4096) == 8 * one
    assert counts.flash_flops(m, 8, 4096) == \
        4 * 8 * 16 * 128 * 4096 * 4097 // 2
    assert counts.peaks("a card nobody listed") is None
