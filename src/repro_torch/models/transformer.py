"""Decoder-only transformer LM, dense and MoE (port of
``repro/models/transformer.py``).

Covers the LM architectures of the model zoo through one config:

- qwen3-0.6b / qwen3-1.7b : GQA, per-head qk RMSNorm, SwiGLU
- gemma2-2b               : GQA, alternating local(window)/global attention,
                            attn + final logit softcaps, GeGLU, sandwich
                            norms, sqrt(d) embedding scaling
- phi3.5-moe-42b          : 16-expert top-2 MoE FFN, untied lm_head
- granite-moe-1b          : 32-expert top-8 MoE FFN (tiny per-expert d_ff)

Names and layouts at the public functions are the JAX module's: tokens
[B, S]; params keyed like the JAX tree (``embed`` [V_padded, d],
``final_norm``, ``layers.wq`` [L, d, H*dh], ...); the KV cache
``{"k", "v"}`` [L, B, S_max, Kh, dh]. Attention runs through the port's
kernels: prefill through ``flash_attention``, decode through
``decode_attention``, each once per layer, on strided views of the
[B, S, H, dh] activations and the cache (no copies). The JAX module
computes the same attention in plain jnp (query-chunked, probabilities
cast to the value dtype before P·V); the kernels keep P in float32.

MoE dispatch is the reference's sort-based top-k into a per-group,
per-expert capacity buffer, in plain torch on both devices (the reference
computes it in XLA, not in a Pallas kernel): a float32 router softmax, a
stable descending sort for top-k (the lower expert id first on equal
probabilities, as ``lax.top_k``), a stable argsort by expert (earlier
tokens win a full expert's slots), batched expert GEMMs and the Switch
load-balance aux loss (see :func:`_moe_core`).

Training: :func:`lm_loss` is the reference's next-token loss on a
forward that autograd can take. Each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference remats each
layer with ``jax.checkpoint``; attention is :class:`FlashAttention` (the
forward kernel writing the row log-sum-exp, the ``flash_attention_bwd``
kernel for dq, dk and dv); the serving path's in-place writes (the
attention ``out=``, the final softcap, the MoE expert GEMM's ``out=`` and
its combine's ``mul_``) take their out-of-place forms there, while
serving keeps them. MoE routing is deterministic (stable sorts), so a
layer's recompute picks the experts its forward picked.

Where the port differs from the reference, by design:

- the KV cache is updated in place (``lm_decode_step`` writes the new
  K/V at ``pos`` and returns the same dict; ``lm_prefill`` with a cache
  writes positions [0, S)), where JAX returns a new cache;
- the MoE combine sums a token's K expert outputs in float32 and rounds
  once, where JAX scatter-adds them in the activations' dtype;
- there is no sharding (``AxisRules``): the port serves from one card, so
  the reference's expert-parallel ``shard_map`` path reduces to its
  single-shard core.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import FlashAttention, flash_attention
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

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense_like = self.param_count() \
            - self.n_layers * self.n_experts * 3 * d * self.d_ff
        return dense_like + self.n_layers * self.top_k * 3 * d * self.d_ff


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_lm_params(cfg: LMConfig, generator: torch.Generator,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None) -> dict:
    """Random parameters in the JAX tree's layout, drawn from
    ``generator`` (a generator on ``device``; ``cuda`` by default).
    Norm scales are float32 ones and an MoE router is float32 (drawn in
    ``dtype``, then cast), as in the reference."""
    dev = resolve_device(device)
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.d_head
    H, Kh, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def dense(*shape):
        # drawn a layer at a time, so the float32 staging is one layer,
        # not a whole stacked [L, E, d, F] expert leaf
        out = torch.empty((L, *shape), dtype=dtype, device=dev)
        for layer in out:
            layer.copy_(dense_init(generator, shape, dtype=dtype, device=dev))
        return out

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
        },
    }
    lay = p["layers"]
    if cfg.sandwich_norm:
        lay["ln_attn_post"] = ones(L, d)
        lay["ln_mlp_post"] = ones(L, d)
    if cfg.qk_norm:
        lay["q_norm"] = ones(L, dh)
        lay["k_norm"] = ones(L, dh)
    if cfg.moe:
        E = cfg.n_experts
        lay["router"] = dense(d, E).float()
        lay["wi_gate"] = dense(E, d, F)
        lay["wi_up"] = dense(E, d, F)
        lay["wo_ffn"] = dense(E, F, d)
    else:
        lay["wi_gate"] = dense(d, F)
        lay["wi_up"] = dense(d, F)
        lay["wo_ffn"] = dense(F, d)
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


def moe_capacity(cfg: LMConfig, Tg: int) -> int:
    """Slots per expert in a group of ``Tg`` tokens: the reference's
    formula (a multiple of 8; ``max(1, ceil(K * capacity_factor))`` for
    short groups, e.g. one decode token)."""
    E, K, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    if Tg * K >= 8 * E:
        return int(max(8, math.ceil(Tg * K / E * cf / 8) * 8))
    return int(max(1, math.ceil(K * cf)))


class MoeRoute(NamedTuple):
    """One group-local dispatch: per group g of Tg tokens, A = Tg * K
    assignments, ``a = t * K + k`` in token order."""
    probs: torch.Tensor      # [G, Tg, E] float32 router softmax
    ids: torch.Tensor        # [G, Tg, K] chosen experts, largest first
    weights: torch.Tensor    # [G, Tg, K] float32, summing to 1 per token
    aux: torch.Tensor        # [] float32 Switch load-balance loss
    capacity: int            # C, slots per expert and group
    order: torch.Tensor      # [G, A] stable argsort of the flat ids
    keep: torch.Tensor       # [G, A] in sorted order: local and in capacity
    dest: torch.Tensor       # [G, A] in sorted order: slot e*C + rank,
    #                          El*C for a dropped or non-local assignment
    token_of: torch.Tensor   # [G, A] in sorted order: the token


def _moe_topk(cfg: LMConfig, router: torch.Tensor, x: torch.Tensor):
    """Steps 1-3 of the reference's ``_moe_core``: the float32 router
    softmax, top-k (a stable descending sort: equal probabilities keep the
    lower expert id first, as ``lax.top_k``), renormalized weights and the
    Switch aux ``E * sum_e f_e P_e`` (f_e from each token's first
    expert). Returns (probs, ids, weights, aux)."""
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = top_p[..., :K], top_i[..., :K]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    f_e = torch.nn.functional.one_hot(ids[..., 0], E).float().mean(
        dim=(0, 1))
    aux = E * torch.sum(f_e * probs.mean(dim=(0, 1)))
    return probs, ids, weights, aux


def _moe_route(cfg: LMConfig, router: torch.Tensor, x: torch.Tensor,
               e0: int, El: int) -> MoeRoute:
    """Steps 1-6 of the reference's ``_moe_core`` for the expert slice
    [e0, e0 + El): :func:`_moe_topk`, the capacity, a stable argsort of the
    flat ids (earlier tokens first within an expert), searchsorted starts,
    rank in expert, keep and dest."""
    G, Tg, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = x.device
    probs, ids, weights, aux = _moe_topk(cfg, router, x)
    C = moe_capacity(cfg, Tg)
    A = Tg * K
    flat_ids = ids.reshape(G, A)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = flat_ids.gather(-1, order)
    starts = torch.searchsorted(
        sorted_ids, torch.arange(E, device=dev).expand(G, E).contiguous())
    rank = torch.arange(A, device=dev) - starts.gather(-1, sorted_ids)
    local_e = sorted_ids - e0
    keep = (rank < C) & (local_e >= 0) & (local_e < El)
    dest = torch.where(keep, local_e * C + rank, El * C)
    return MoeRoute(probs, ids, weights, aux, C, order, keep, dest,
                    order // K)


def _moe_core(cfg: LMConfig, router: torch.Tensor, wi_gate: torch.Tensor,
              wi_up: torch.Tensor, wo_ffn: torch.Tensor, x: torch.Tensor,
              e0: int = 0, train: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-local sort-based top-k dispatch for the contiguous expert
    slice [e0, e0 + wi_gate.shape[0]) (the reference's ``_moe_core``).

    x [G, Tg, D] (one group per sequence); router [D, E] scores all E
    experts; assignments to experts outside the slice contribute zero, so
    slices sum to the whole. Returns (y [G, Tg, D] in x's dtype, aux).

    Each group's kept assignments go into a capacity buffer laid out
    [El, G, C, D] (empty slots zero), the experts run as three batched
    GEMMs, ``act(buf @ wi_gate) * (buf @ wi_up) @ wo_ffn``, and each token
    gathers its K rows back through the inverse of the sort. The port's
    numerics: the weights are cast to x's dtype, as in the reference, and
    each token's K weighted rows are summed in float32 in a fixed order
    and rounded once (the reference scatter-adds them in x's dtype, which
    an atomic ``index_add_`` would reorder from run to run). ``train``
    computes the same values out of place, so autograd can take them."""
    G, Tg, D = x.shape
    El = wi_gate.shape[0]
    act = ACTIVATIONS[cfg.act]
    r = _moe_route(cfg, router, x, e0, El)
    C = r.capacity
    g = torch.arange(G, device=x.device)[:, None]
    # slot of each sorted assignment in the [El, G, C] buffer; the dump
    # slot El*G*C takes the dropped ones
    slot = torch.where(r.keep, (r.dest // C) * (G * C) + g * C + r.dest % C,
                       El * G * C)
    src = torch.full((El * G * C + 1,), G * Tg, dtype=torch.long,
                     device=x.device)
    src[slot] = g * Tg + r.token_of                  # the dump slot: any
    rows = torch.cat([x.reshape(G * Tg, D), x.new_zeros(1, D)])
    buf = rows[src[:-1]].view(El, G * C, D)          # empty slots: zeros
    h = act(torch.bmm(buf, wi_gate)) * torch.bmm(buf, wi_up)
    if train:
        out = torch.cat([torch.bmm(h, wo_ffn).view(El * G * C, D),
                         x.new_zeros(1, D)])
    else:
        out = x.new_empty(El * G * C + 1, D)         # + a zero dump row
        torch.bmm(h, wo_ffn, out=out[:-1].view(El, G * C, D))
        out[-1] = 0

    # back to token order: slot and keep of assignment a = t * K + k
    slot_tok = torch.empty_like(slot).scatter_(1, r.order, slot)
    keep_tok = torch.empty_like(r.keep).scatter_(1, r.order, r.keep)
    w = (r.weights.to(x.dtype) * keep_tok.view(G, Tg, -1)).float()
    y = out[slot_tok].float().view(G, Tg, -1, D)     # [G, Tg, K, D]
    y = (y * w[..., None] if train else y.mul_(w[..., None])).sum(dim=2)
    return y.to(x.dtype), r.aux


def moe_ffn(cfg: LMConfig, lp: dict, x: torch.Tensor, train: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN on one card: the reference's single-shard branch. Its
    expert-parallel ``shard_map`` path runs :func:`_moe_core` on each
    expert slice and sums the slices, which on one card is the whole."""
    return _moe_core(cfg, lp["router"], lp["wi_gate"], lp["wi_up"],
                     lp["wo_ffn"], x, 0, train)


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
              attn: torch.Tensor, train: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Output projection, then the FFN half of the layer: (x, the MoE
    aux loss, None for a dense FFN)."""
    B, S = x.shape[:2]
    attn = attn.reshape(B, S, cfg.n_heads * cfg.d_head) @ lp["wo"]
    if cfg.sandwich_norm:
        attn = rms_norm(attn, lp["ln_attn_post"])
    x = x + attn
    h = rms_norm(x, lp["ln_mlp"])
    if cfg.moe:
        out, aux = moe_ffn(cfg, lp, h, train)
    else:
        out, aux = dense_ffn(cfg, lp, h), None
    if cfg.sandwich_norm:
        out = rms_norm(out, lp["ln_mlp_post"])
    return x + out, aux


def _logits(cfg: LMConfig, params: dict, x: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.final_softcap is not None:
        cap = cfg.final_softcap
        if train:
            return torch.tanh(logits / cap) * cap
        # in place when serving: prefill logits are large
        logits.div_(cap).tanh_().mul_(cap)
    return logits


def _layer(cfg: LMConfig, lp: dict, x: torch.Tensor, window: int,
           rot: tuple, kv_out: tuple | None = None, train: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One prefill layer, (x, aux) as :func:`_residual`; ``kv_out`` =
    (k_cache, v_cache) [B, S_max, Kh, dh] views of one layer's cache,
    written at [0, S). ``train``: attention through
    :class:`FlashAttention` and every op out of place."""
    q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln_attn"]), rot)
    if train:
        attn = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), window,
                                    cfg.attn_softcap or 0.0)
        return _residual(cfg, lp, x, attn.transpose(1, 2), True)
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
    """tokens [B, S] -> (logits [B, S, V_padded], aux_loss): the MoE
    layers' mean Switch aux loss, 0 for a dense config. Runs on the
    params' device."""
    return _forward(cfg, params, tokens, None)


def _forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
             cache: dict | None, train: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    rot = rope_tables(torch.arange(S, device=x.device).expand(B, S),
                      cfg.d_head, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, window in enumerate(cfg.layer_windows().tolist()):
        lp = layer_params(params, layer)
        if train:   # rematted: the backward recomputes the layer
            x, aux_l = checkpoint(_layer, cfg, lp, x, window, rot, None,
                                  True, use_reentrant=False)
        else:
            kv = None if cache is None else (cache["k"][layer],
                                             cache["v"][layer])
            x, aux_l = _layer(cfg, lp, x, window, rot, kv)
        if aux_l is not None:
            aux = aux + aux_l
    return _logits(cfg, params, x, train), aux / cfg.n_layers


def lm_loss(cfg: LMConfig, params: dict, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy over [B, S] tokens (the reference's
    ``lm_loss``): the mean NLL of tokens 1..S-1 from the float32 logits of
    positions 0..S-2, plus ``aux_loss_weight`` times the MoE layers' mean
    aux loss. Returns (loss, {"nll", "aux"}), 0-dim float32 tensors with a
    gradient to every leaf of ``params`` that requires one."""
    logits, aux = _forward(cfg, params, tokens, None, train=True)
    nll = torch.nn.functional.cross_entropy(
        logits[:, :-1].float().flatten(0, 1), tokens[:, 1:].flatten().long())
    loss = nll + cfg.aux_loss_weight * aux
    return loss, {"nll": nll, "aux": aux}


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
    returns (logits [B, 1, V_padded], the same cache dict). An MoE
    layer's aux loss is discarded, as in the reference.

    An int ``pos`` outside ``[0, max_seq)`` raises ``ValueError`` before
    anything is written. This departs from the reference, whose
    ``dynamic_update_slice`` clamps the write to the last slot and decodes
    on: copying that would silently overwrite the last cache row. A tensor
    ``pos`` is not checked, since reading it would sync with the device;
    the caller keeps it in range."""
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
        x = _residual(cfg, lp, x, attn)[0]
    return _logits(cfg, params, x), cache
