"""Decoder-only transformer LM, dense path (port of
``repro/models/transformer.py``).

Covers the dense LM architectures of the model zoo through one config:

- qwen3-0.6b / qwen3-1.7b : GQA, per-head qk RMSNorm, SwiGLU
- gemma2-2b               : GQA, alternating local(window)/global attention,
                            attn + final logit softcaps, GeGLU, sandwich
                            norms, sqrt(d) embedding scaling

Names and layouts at the public functions are the JAX module's: tokens
[B, S]; params keyed like the JAX tree (``embed`` [V_padded, d],
``final_norm``, ``layers.wq`` [L, d, H*dh], ...); the KV cache
``{"k", "v"}`` [L, B, S_max, Kh, dh]. Attention runs through the port's
kernels: prefill through ``flash_attention``, decode through
``decode_attention``, each once per layer, on strided views of the
[B, S, H, dh] activations and the cache (no copies). The JAX module
computes the same attention in plain jnp (query-chunked, probabilities
cast to the value dtype before P·V); the kernels keep P in float32.

Where the port differs from the reference, by design:

- the KV cache is updated in place (``lm_decode_step`` writes the new
  K/V at ``pos`` and returns the same dict; ``lm_prefill`` with a cache
  writes positions [0, S)), where JAX returns a new cache;
- MoE (``n_experts > 0``), ``lm_loss`` and training are not ported yet:
  an MoE config raises ``NotImplementedError``;
- there is no sharding (``AxisRules``): the port serves from one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from .common import (ACTIVATIONS, apply_rope, dense_init, embed_init,
                     rms_norm, rope_tables)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    # MoE
    n_experts: int = 0                  # 0 == dense FFN
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # attention flavor
    attn_pattern: str = "global"        # "global" | "local_global"
    window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    sandwich_norm: bool = False         # gemma2 pre+post norms
    scale_embed: bool = False           # gemma2 sqrt(d_model) embed scaling
    rope_theta: float = 10_000.0
    act: str = "silu"
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 256
    q_chunk: int = 512

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_windows(self) -> np.ndarray:
        """Per-layer attention window (0 == global causal)."""
        if self.attn_pattern == "local_global":
            # gemma2: even layers local sliding-window, odd layers global
            return np.array([self.window if i % 2 == 0 else 0
                             for i in range(self.n_layers)], dtype=np.int32)
        return np.zeros(self.n_layers, dtype=np.int32)

    def param_count(self) -> int:
        """Exact parameter count (excl. vocab padding)."""
        d, dh = self.d_model, self.d_head
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        if self.moe:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        norms = d * (4 if self.sandwich_norm else 2)
        if self.qk_norm:
            norms += 2 * dh
        per_layer = attn + ffn + norms
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


def _dense_only(cfg: LMConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (dense path only)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_lm_params(cfg: LMConfig, generator: torch.Generator,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None) -> dict:
    """Random parameters in the JAX tree's layout, drawn from
    ``generator`` (a generator on ``device``; ``cuda`` by default).
    Norm scales are float32 ones, as in the reference."""
    _dense_only(cfg)
    dev = resolve_device(device)
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.d_head
    H, Kh, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def dense(*shape):
        return dense_init(generator, (L, *shape), dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    p: dict = {
        "embed": embed_init(generator, (cfg.padded_vocab, d), dtype=dtype,
                            device=dev),
        "final_norm": ones(d),
        "layers": {
            "wq": dense(d, H * dh),
            "wk": dense(d, Kh * dh),
            "wv": dense(d, Kh * dh),
            "wo": dense(H * dh, d),
            "ln_attn": ones(L, d),
            "ln_mlp": ones(L, d),
            "wi_gate": dense(d, F),
            "wi_up": dense(d, F),
            "wo_ffn": dense(F, d),
        },
    }
    lay = p["layers"]
    if cfg.sandwich_norm:
        lay["ln_attn_post"] = ones(L, d)
        lay["ln_mlp_post"] = ones(L, d)
    if cfg.qk_norm:
        lay["q_norm"] = ones(L, dh)
        lay["k_norm"] = ones(L, dh)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (d, cfg.padded_vocab),
                                  dtype=dtype, device=dev)
    return p


def layer_params(params: dict, layer: int) -> dict:
    """Layer ``layer``'s slice of the stacked ``params["layers"]`` (views)."""
    return {k: v[layer] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def dense_ffn(cfg: LMConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    return (act(x @ lp["wi_gate"]) * (x @ lp["wi_up"])) @ lp["wo_ffn"]


def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.scale_embed:     # the factor rounded to x's dtype, as in JAX
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def _qkv(cfg: LMConfig, lp: dict, h: torch.Tensor, rot: tuple):
    """Projections, qk norms and rotary embeddings (``rot`` = the pass's
    :func:`rope_tables`): [B, S, heads, dh]."""
    B, S, _ = h.shape
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (h @ lp["wq"]).view(B, S, H, dh)
    k = (h @ lp["wk"]).view(B, S, Kh, dh)
    v = (h @ lp["wv"]).view(B, S, Kh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    return apply_rope(q, *rot), apply_rope(k, *rot), v


def _residual(cfg: LMConfig, lp: dict, x: torch.Tensor,
              attn: torch.Tensor) -> torch.Tensor:
    """Output projection, then the FFN half of the layer."""
    B, S = x.shape[:2]
    attn = attn.reshape(B, S, cfg.n_heads * cfg.d_head) @ lp["wo"]
    if cfg.sandwich_norm:
        attn = rms_norm(attn, lp["ln_attn_post"])
    x = x + attn
    out = dense_ffn(cfg, lp, rms_norm(x, lp["ln_mlp"]))
    if cfg.sandwich_norm:
        out = rms_norm(out, lp["ln_mlp_post"])
    return x + out


def _logits(cfg: LMConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.final_softcap is not None:    # in place: prefill logits are large
        cap = cfg.final_softcap
        logits.div_(cap).tanh_().mul_(cap)
    return logits


def _layer(cfg: LMConfig, lp: dict, x: torch.Tensor, window: int,
           rot: tuple, kv_out: tuple | None = None) -> torch.Tensor:
    """One prefill layer; ``kv_out`` = (k_cache, v_cache) [B, S_max, Kh,
    dh] views of one layer's cache, written at [0, S)."""
    q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln_attn"]), rot)
    if kv_out is not None:
        S = x.shape[1]
        kv_out[0][:, :S] = k
        kv_out[1][:, :S] = v
    attn = torch.empty_like(q)                       # [B, S, H, dh]
    flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    window=window, softcap=cfg.attn_softcap or 0.0,
                    out=attn.transpose(1, 2))
    return _residual(cfg, lp, x, attn)


# ---------------------------------------------------------------------------
# forward and serving
# ---------------------------------------------------------------------------

@torch.no_grad()
def lm_forward(cfg: LMConfig, params: dict, tokens: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V_padded], aux_loss). The dense
    path's aux loss is 0. Runs on the params' device."""
    return _forward(cfg, params, tokens, None)


def _forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
             cache: dict | None) -> tuple[torch.Tensor, torch.Tensor]:
    _dense_only(cfg)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    rot = rope_tables(torch.arange(S, device=x.device).expand(B, S),
                      cfg.d_head, cfg.rope_theta)
    for layer, window in enumerate(cfg.layer_windows().tolist()):
        kv = None if cache is None else (cache["k"][layer],
                                         cache["v"][layer])
        x = _layer(cfg, layer_params(params, layer), x, window, rot, kv)
    return _logits(cfg, params, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


@torch.no_grad()
def lm_prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor,
               cache: dict | None = None) -> torch.Tensor:
    """Prefill pass: logits [B, S, V_padded]. With ``cache`` (from
    :func:`init_kv_cache`, ``S_max >= S``) each layer's K/V are written in
    place at positions [0, S), so decoding can go on from position S; the
    JAX prefill returns logits only."""
    if cache is not None and cache["k"].shape[2] < tokens.shape[1]:
        raise ValueError(f"cache holds {cache['k'].shape[2]} positions, "
                         f"prompt has {tokens.shape[1]}")
    return _forward(cfg, params, tokens, cache)[0]


def init_kv_cache(cfg: LMConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: str | torch.device | None = None) -> dict:
    """Zero KV cache ``{"k", "v"}`` [L, B, max_seq, Kh, dh] on ``device``
    (``cuda`` by default)."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def lm_decode_step(cfg: LMConfig, params: dict, cache: dict,
                   tokens: torch.Tensor, pos: int | torch.Tensor
                   ) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens [B, 1]; pos: the current index, shared by
    the batch (an int or a 0-dim integer tensor on the tokens' device).

    Writes each layer's new K/V into ``cache`` **in place** at ``pos``,
    attends to positions <= pos (and > pos - window on local layers), and
    returns (logits [B, 1, V_padded], the same cache dict).

    An int ``pos`` outside ``[0, max_seq)`` raises ``ValueError`` before
    anything is written. This departs from the reference, whose
    ``dynamic_update_slice`` clamps the write to the last slot and decodes
    on: copying that would silently overwrite the last cache row. A tensor
    ``pos`` is not checked, since reading it would sync with the device;
    the caller keeps it in range."""
    _dense_only(cfg)
    max_seq = cache["k"].shape[2]
    if not isinstance(pos, torch.Tensor) and not 0 <= int(pos) < max_seq:
        raise ValueError(f"pos {int(pos)} is outside the cache's "
                         f"[0, {max_seq}) positions")
    B = tokens.shape[0]
    x = _embed(cfg, params, tokens)
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=x.device, dtype=torch.int64).reshape(1)
    else:                       # filled on the device: no copy, no sync
        pos_t = torch.full((1,), int(pos), dtype=torch.int64,
                           device=x.device)
    rot = rope_tables(pos_t.expand(B, 1), cfg.d_head, cfg.rope_theta)
    lengths = (pos_t + 1).to(torch.int32).expand(B).contiguous()
    softcap = cfg.attn_softcap or 0.0
    for layer, window in enumerate(cfg.layer_windows().tolist()):
        lp = layer_params(params, layer)
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln_attn"]), rot)
        kc, vc = cache["k"][layer], cache["v"][layer]   # [B, S_max, Kh, dh]
        kc.index_copy_(1, pos_t, k.to(kc.dtype))
        vc.index_copy_(1, pos_t, v.to(vc.dtype))
        attn = decode_attention(q[:, 0], kc.transpose(1, 2),
                                vc.transpose(1, 2), lengths, window=window,
                                softcap=softcap)        # [B, H, dh]
        x = _residual(cfg, lp, x, attn)
    return _logits(cfg, params, x), cache
