"""The plain reference against the port's torch route (the kernels' plain
versions on the CPU) in float32 at a tiny size: the prefill's logits and
the cache it writes, MoE capacity drops included."""

import pytest
import torch

import _tiny
from portbench import inputs, reference, serve


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("config", [_tiny.DENSE, _tiny.MOE],
                         ids=["dense", "moe"])
def test_reference_equals_port_in_float32(config):
    """Logits and the cache the port's prefill writes, row by row."""
    from repro_torch.models import transformer as tf
    m = reference.Model.from_config(config)
    cfg = serve.lm_config(m, config)
    w = f32(inputs.weights(m, 5, "cpu"))
    tok = torch.randint(0, m.vocab, (2, 200),
                        generator=torch.Generator().manual_seed(1))
    cache = tf.init_kv_cache(cfg, 2, 200, dtype=torch.float32, device="cpu")
    got = tf.lm_prefill(cfg, w, tok, cache)[..., :m.vocab]
    for b in range(2):
        keep, gaps = [], []
        want = reference.logits(m, w, reference.final_hidden(
            m, w, tok[b], keep=keep,
            against=lambda i: (cache["k"][i, b], cache["v"][i, b]),
            gaps=gaps))
        torch.testing.assert_close(got[b], want, rtol=0, atol=5e-5)
        assert len(keep) == len(gaps) // 2 == m.layers
        for i, (k, v) in enumerate(keep):
            torch.testing.assert_close(cache["k"][i, b], k, rtol=0,
                                       atol=2e-5)
            torch.testing.assert_close(cache["v"][i, b], v, rtol=0,
                                       atol=2e-5)
        assert max(gaps) < 1e-5


def test_gap_is_relative_to_what_it_is_held_against():
    want = torch.tensor([3.0, 4.0])
    assert reference.gap(want, want) == 0
    assert reference.gap(torch.zeros(2), want) == 1
    assert reference.gap(torch.tensor([3.0, 4.5]), want) == \
        pytest.approx(0.1)


def test_capacity_drops_the_latest_tokens():
    m = reference.Model.from_config(_tiny.MOE)
    assert m.capacity(200) == 64 and m.capacity(1) == 3
    x = torch.randn(1, m.d).expand(200, m.d).contiguous()   # all alike
    lw = {k: v[0].float() for k, v in
          inputs.weights(m, 3, "cpu")["layers"].items()}
    y = reference.moe_ffn(m, x, lw, "fp32")
    assert torch.allclose(y[:64], y[:1].expand(64, -1), atol=1e-6)
    assert torch.equal(y[64:], torch.zeros_like(y[64:]))


def test_fp8_control_rounds_to_e4m3():
    x = torch.tensor([[1.0, 0.3, -448.0]])
    q = reference.fp8(x, -1)
    assert q[0, 2] == -448.0 and q[0, 0] == 1.0 and q[0, 1] != 0.3


@pytest.mark.parametrize("extra", [
    {"logits_scaling": 6.0}, {"embedding_multiplier": 12.0},
    {"residual_multiplier": 0.22}, {"attention_multiplier": 0.015625},
    {"rms_norm_eps": 1e-5}, {"tie_word_embeddings": False}])
def test_program_config_refuses_what_the_program_does_not_run(extra):
    """GraniteMoE's published muP scalars, another norm eps or an untied
    head: the harness refuses to serve the configuration."""
    config = dict(_tiny.MOE, **extra)
    with pytest.raises(ValueError):
        serve.lm_config(reference.Model.from_config(config), config)
