"""The benchmark's inputs, made from ``--seed`` on the device: weights and
prompts. The same seed gives
the same inputs; both the program and the reference are handed these.

Each leaf is drawn in one call of a generator on the device, in the type it
is served in, and laid out as the program takes its parameters (the stacked
``layers`` tree of ``repro_torch.models.transformer``). Weights are normal
with a standard deviation of one over the root of their fan-in; norm scales
are float32 near one; rows of the embedding past the published vocabulary
(the program pads it) are zero.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by ``tags`` under ``seed``."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def padded(vocab: int, multiple: int = 256) -> int:
    return -(-vocab // multiple) * multiple


def weights(m, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Parameters of the reference ``Model`` ``m`` in the program's layout."""
    L, d, H, Kh, dh, F = (m.layers, m.d, m.heads, m.kv_heads, m.head_dim,
                          m.ffn)
    g = generator(device, seed, "weights")

    def normal(*shape, fan_in, dt=dtype):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(0.0, fan_in ** -0.5, generator=g)

    def scale(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(1.0, 0.1, generator=g)

    embed = normal(padded(m.vocab), d, fan_in=d)
    embed[m.vocab:] = 0
    lay = {"wq": normal(L, d, H * dh, fan_in=d),
           "wk": normal(L, d, Kh * dh, fan_in=d),
           "wv": normal(L, d, Kh * dh, fan_in=d),
           "wo": normal(L, H * dh, d, fan_in=H * dh),
           "ln_attn": scale(L, d), "ln_mlp": scale(L, d)}
    if m.qk_norm:
        lay["q_norm"] = scale(L, dh)
        lay["k_norm"] = scale(L, dh)
    if m.experts:
        E = m.experts
        lay["router"] = normal(L, d, E, fan_in=d, dt=torch.float32)
        lay["wi_gate"] = normal(L, E, d, F, fan_in=d)
        lay["wi_up"] = normal(L, E, d, F, fan_in=d)
        lay["wo_ffn"] = normal(L, E, F, d, fan_in=F)
    else:
        lay["wi_gate"] = normal(L, d, F, fan_in=d)
        lay["wi_up"] = normal(L, d, F, fan_in=d)
        lay["wo_ffn"] = normal(L, F, d, fan_in=F)
    return {"embed": embed, "final_norm": scale(d), "layers": lay}


class Prompts:
    """Request i's prompts, [batch, S] token ids of the published
    vocabulary: the i-th draw of one generator (of the stream ``tag``)."""

    def __init__(self, m, seed: int, device, batch: int, S: int,
                 tag: str = "prompts"):
        self.g = generator(device, seed, tag)
        self.shape, self.vocab, self.device = (batch, S), m.vocab, device

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.g,
                             device=self.device)
