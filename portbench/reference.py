"""The plain reference: a decoder-only LM's forward pass in float32, in plain
PyTorch, written from the published equations of the configurations the
benchmark serves (Qwen3's and GraniteMoE's modelling code), dense and MoE.

It imports nothing of the program under test and takes nothing the program
made: the benchmark hands it the same token ids and weights it handed the
program (its own inputs, drawn from the seed), and it works out every
activation, key and value again. Matrix products run with TF32
off, so float32 means float32 on the card.

One prompt at a time, over its ``n`` tokens at positions ``0 .. n - 1``.
Attention runs over blocks of query rows (the caller takes the head over
blocks of positions), so a 32,768-token prompt fits on the card. Each
layer's keys (after the norm and the rotary embedding) and values can be
kept, or held against the cache the program wrote.

``precision="fp8"`` is the control: every linear layer's operands rounded
to float8 e4m3 (weights by one scale a matrix, activations by one scale a
row), the step below the bfloat16 the configurations state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

FP8_MAX = 448.0          # the largest finite float8 e4m3 value
QUERY_BLOCK = 512        # query rows an attention block


@dataclass(frozen=True)
class Model:
    """The shape and constants of one configuration file."""
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    eps: float
    rope_theta: float
    qk_norm: bool
    experts: int
    top_k: int
    capacity_factor: float

    @classmethod
    def from_config(cls, c: dict) -> "Model":
        d, H = c["hidden_size"], c["num_attention_heads"]
        dh = c.get("head_dim") or d // H
        return cls(
            layers=c["num_hidden_layers"], d=d, heads=H,
            kv_heads=c["num_key_value_heads"], head_dim=dh,
            ffn=c["intermediate_size"], vocab=c["vocab_size"],
            eps=c["rms_norm_eps"], rope_theta=float(c["rope_theta"]),
            qk_norm=c["model_type"] == "qwen3",
            experts=c.get("num_local_experts", 0),
            top_k=c.get("num_experts_per_tok", 0),
            capacity_factor=c.get("capacity_factor", 0.0))

    def capacity(self, group: int) -> int:
        """Slots an expert has in a group of ``group`` tokens: the
        capacity factor's share of the group's assignments, rounded up to a
        multiple of 8 and at least 8; a group too small for that (a decode
        token) gets ``ceil(top_k * capacity_factor)``, which no token can
        fill."""
        E, K, cf = self.experts, self.top_k, self.capacity_factor
        if group * K >= 8 * E:
            return max(8, math.ceil(group * K / E * cf / 8) * 8)
        return max(1, math.ceil(K * cf))


def fp8(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 and back, scaled by its largest
    magnitude over ``dim`` (None: the whole tensor)."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    scale = amax.clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x [n, k] @ w [k, m] in float32, or on float8 operands."""
    w = w.float()
    if precision == "fp8":
        return fp8(x, -1) @ fp8(w, None)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rotate(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [n, heads, dh] at positions ``pos`` [n]: the
    two halves of each head rotated by ``pos * theta ** (-2 i / dh)``."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.double()[:, None] * inv).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: Model, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q [n, H, dh] over k, v [n, Kh, dh] (positions 0
    .. n - 1); query head h reads kv head h // (H / Kh). Returns
    [n, H * dh]."""
    n, H, dh = q.shape
    G = H // m.kv_heads
    kh = k.repeat_interleave(G, dim=1).transpose(0, 1).contiguous()
    vh = v.repeat_interleave(G, dim=1).transpose(0, 1).contiguous()
    qh = q.transpose(0, 1)                              # [H, n, dh]
    out = torch.empty(H, n, dh, dtype=torch.float32, device=q.device)
    for q0 in range(0, n, QUERY_BLOCK):
        q1 = min(n, q0 + QUERY_BLOCK)
        s = qh[:, q0:q1] @ kh[:, :q1].transpose(1, 2) \
            * dh ** -0.5                                # [H, rows, keys]
        qpos = torch.arange(q0, q1, device=q.device)
        mask = torch.arange(q1, device=q.device)[None, :] > qpos[:, None]
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        out[:, q0:q1] = p @ vh[:, :q1]
    return out.transpose(0, 1).reshape(n, H * dh)


def dense_ffn(x: torch.Tensor, lw: dict, precision: str) -> torch.Tensor:
    h = torch.nn.functional.silu(linear(x, lw["wi_gate"], precision)) \
        * linear(x, lw["wi_up"], precision)
    return linear(h, lw["wo_ffn"], precision)


def moe_ffn(m: Model, x: torch.Tensor, lw: dict,
            precision: str) -> torch.Tensor:
    """Top-k of a float32 router softmax, the k weights renormalised to
    sum to one. The prompt's tokens are one capacity group, where an
    expert takes the earliest tokens that chose it up to its capacity and
    the rest of its assignments add nothing."""
    n = x.shape[0]
    probs = torch.softmax(x @ lw["router"].float(), dim=-1)
    top_p, top_i = probs.topk(m.top_k, dim=-1)
    weight = top_p / top_p.sum(-1, keepdim=True)
    chose = torch.zeros(n, m.experts, dtype=torch.float32, device=x.device)
    chose.scatter_(1, top_i, 1.0)
    per = torch.zeros_like(chose).scatter_(1, top_i, weight)
    kept = (chose > 0) & (chose.cumsum(0) - 1 < m.capacity(n))
    y = torch.zeros_like(x)
    for e in range(m.experts):
        rows = kept[:, e].nonzero()[:, 0]
        if rows.numel():
            xe = x[rows]
            h = torch.nn.functional.silu(
                linear(xe, lw["wi_gate"][e], precision)) \
                * linear(xe, lw["wi_up"][e], precision)
            y.index_add_(0, rows, linear(h, lw["wo_ffn"][e], precision)
                         * per[rows, e, None])
    return y


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far ``got`` lies from ``want``: the norm of their difference
    over the norm of ``want``."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))


@torch.no_grad()
def final_hidden(m: Model, w: dict, tokens: torch.Tensor,
                 precision: str = "fp32", keep: list | None = None,
                 against=None, gaps: list | None = None) -> torch.Tensor:
    """The final-normed hidden states [n, d] (float32) of one prompt's
    ``tokens`` [n]. ``keep``: a list each layer's (k, v) [n, Kh, dh] is
    appended to. ``against``: a function of a layer giving the (k, v)
    another side computed; the :func:`gap` of each to this pass's is
    appended to ``gaps``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = tokens.shape[0]
    H, Kh, dh = m.heads, m.kv_heads, m.head_dim
    pos = torch.arange(n, device=tokens.device)
    x = w["embed"][tokens].float()
    lay = w["layers"]
    for i in range(m.layers):
        lw = {k: v[i] for k, v in lay.items()}
        h = rms_norm(x, lw["ln_attn"], m.eps)
        q = linear(h, lw["wq"], precision).view(n, H, dh)
        k = linear(h, lw["wk"], precision).view(n, Kh, dh)
        v = linear(h, lw["wv"], precision).view(n, Kh, dh)
        if m.qk_norm:
            q = rms_norm(q, lw["q_norm"], m.eps)
            k = rms_norm(k, lw["k_norm"], m.eps)
        q, k = rotate(q, pos, m.rope_theta), rotate(k, pos, m.rope_theta)
        if keep is not None:
            keep.append((k, v))
        if against is not None:
            ok, ov = against(i)
            gaps += [gap(ok, k), gap(ov, v)]
        a = linear(attention(m, q, k, v), lw["wo"], precision)
        x = x + a
        h = rms_norm(x, lw["ln_mlp"], m.eps)
        f = (moe_ffn(m, h, lw, precision) if m.experts
             else dense_ffn(h, lw, precision))
        x = x + f
    return rms_norm(x, w["final_norm"], m.eps)


def logits(m: Model, w: dict, h: torch.Tensor, precision: str = "fp32"
           ) -> torch.Tensor:
    """Float32 logits [n, vocab] of hidden states h [n, d]: the tied
    embedding's rows of the published vocabulary."""
    head = w["embed"][:m.vocab].T
    return linear(h, head, precision)
