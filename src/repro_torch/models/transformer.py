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
Where no gradient is carried, on the card, a layer's qk-norm and RoPE of
q and k are one ``norm_rope`` launch and each RMSNorm one
``rms_norm_rows`` launch (:mod:`repro_torch.kernels.norm`), with the
plain versions' rounding points; the training route, the CPU and the
meta device keep the plain versions.

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

Spans (:mod:`repro_torch.spans`): while ``torch.profiler`` records, each
:func:`lm_prefill` call records a ``prefill`` root holding ``embed``, then
a layer's ``attn_norm``, ``qkv``, ``qk_norm_rope``, ``kv_write`` (with a
cache), ``attention``, ``attn_out``, ``ffn_norm`` and ``ffn`` for each
layer in turn, then ``logits``, with their device times.
:func:`lm_forward`, :func:`lm_loss` and decode open no root and record
nothing.

Where the port differs from the reference, by design:

- the KV cache is updated in place (``lm_decode_step`` writes the new
  K/V at ``pos`` and returns the same dict; ``lm_prefill`` with a cache
  writes positions [0, S)), where JAX returns a new cache;
- the MoE combine sums a token's K expert outputs in float32 and rounds
  once, where JAX scatter-adds them in the activations' dtype.

Under a mesh (``rules``, an :class:`~repro_torch.models.common.AxisRules`
with a ``DeviceMesh``) every function runs on this rank's pieces of the
reference's layouts (:func:`param_shardings`, :func:`cache_shardings`,
cut by ``convert.local_shard``) and states each collective that GSPMD
inserts for the reference (:mod:`repro_torch.launch.collectives`):

- FSDP: each layer all-gathers its weights over ``fsdp`` just before use,
  inside the layer's checkpoint (the recompute gathers again); the
  gather's backward ``psum_scatter``s each leaf's gradient over ``data``;
- TP: the column-parallel products (``wq``, ``wi_gate``, ``wi_up``, the
  vocabulary-sharded head) take their input through ``pvary`` over
  ``tp``, the row-parallel ones (``wo``, ``wo_ffn``) end in a ``psum``
  over ``tp``; ``wk``, ``wv`` and the qk norms, replicated over ``tp``,
  enter through ``pvary`` too, so every replicated leaf's gradient is
  whole on each ``tp`` rank;
- GQA: a rank computes the kv heads its query heads read (the columns of
  ``wk``/``wv`` sliced after the gather); where ``n_heads % tp != 0``
  (gemma2-2b's 8 heads at tp = 16) ``wq`` is gathered over ``tp`` as well
  and every ``tp`` rank computes every head, ``wo`` staying row-parallel
  on the rank's rows of the attention output: the same numbers as the
  reference, at ``tp`` times its attention compute (a stated divergence);
- the embedding is vocabulary-parallel (a masked lookup into the rank's
  rows, ``psum`` over ``tp``); logits stay vocabulary-sharded, [B, S,
  V/tp] (the reference's ``constrain(logits, batch, None, tp)``), and
  :func:`lm_loss` is a vocabulary-parallel float32 cross-entropy;
- the MoE layers take the expert-parallel route (:func:`moe_ffn`);
- decode (:func:`lm_decode_step`) reads a sequence-sharded cache: each
  rank attends over its own slice for every head and the ranks' outputs
  are combined through ``decode_attention``'s log-sum-exp
  (:func:`lse_combine`). It takes an int ``pos`` only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import spans
from ..device import resolve_device
from ..kernels import norm
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import FlashAttention, flash_attention
from ..launch import collectives as col
from .common import (ACTIVATIONS, dense_init, embed_init, on_mesh,
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
# layouts on a mesh
# ---------------------------------------------------------------------------

def param_shardings(cfg: LMConfig, rules) -> dict:
    """The reference's ``param_shardings`` (FSDP + TP) as
    ``{path: spec}`` for ``convert.local_shard``: each spec leads with the
    stacked layer axis (``None``) under ``layers/``."""
    fs, tp = rules.fsdp, rules.tp
    lay = {"wq": (None, fs, tp), "wk": (None, fs, None),
           "wv": (None, fs, None), "wo": (None, tp, fs),
           "ln_attn": (None, None), "ln_mlp": (None, None)}
    if cfg.sandwich_norm:
        lay["ln_attn_post"] = lay["ln_mlp_post"] = (None, None)
    if cfg.qk_norm:
        lay["q_norm"] = lay["k_norm"] = (None, None)
    if cfg.moe:
        lay["router"] = (None, fs, None)
        lay["wi_gate"] = lay["wi_up"] = (None, tp, fs, None)
        lay["wo_ffn"] = (None, tp, None, fs)
    else:
        lay["wi_gate"] = lay["wi_up"] = (None, fs, tp)
        lay["wo_ffn"] = (None, tp, fs)
    out = {"embed": (tp, fs), "final_norm": (None,)}
    out.update({f"layers/{k}": v for k, v in lay.items()})
    if not cfg.tie_embeddings:
        out["lm_head"] = (fs, tp)
    return out


def cache_axes(rules, seq_shard: bool = False) -> tuple:
    """The mesh axes that shard the cache's sequence: ``tp``, or ``(fsdp,
    tp)`` under ``seq_shard``."""
    if seq_shard and rules.fsdp:
        return (rules.fsdp, rules.tp)
    return (rules.tp,)


def cache_shardings(cfg: LMConfig, rules, seq_shard: bool = False) -> dict:
    """The reference's ``cache_shardings``: [L, B, S, Kh, dh] with the
    batch over the batch axes and the sequence over ``tp``; under
    ``seq_shard`` (B = 1, long context) the sequence over ``(fsdp, tp)``."""
    if seq_shard:
        spec = (None, None, cache_axes(rules, True), None, None)
    else:
        spec = (None, rules.batch, rules.tp, None, None)
    return {"k": spec, "v": spec}


def _fsdp(w: torch.Tensor, rules, dim: int) -> torch.Tensor:
    """``w`` all-gathered over ``fsdp`` on ``dim``; ``w`` itself without a
    mesh or an ``fsdp`` axis."""
    if not on_mesh(rules) or rules.fsdp is None:
        return w
    return col.all_gather(w, rules.mesh, rules.fsdp, dim=dim)


def _vary(x: torch.Tensor, rules) -> torch.Tensor:
    """``pvary`` over ``tp``; ``x`` itself without a mesh."""
    return col.pvary(x, rules.mesh, rules.tp) if on_mesh(rules) else x


def _tp_sum(x: torch.Tensor, rules) -> torch.Tensor:
    """``psum`` over ``tp``; ``x`` itself without a mesh."""
    return col.psum(x, rules.mesh, rules.tp) if on_mesh(rules) else x


class HeadLayout(NamedTuple):
    """A ``tp`` rank's attention heads: query heads [h0, h0 + n_q), kv
    heads [k0, k0 + n_kv); ``replicated``: every head on every rank
    (``n_heads % tp != 0``)."""
    h0: int
    n_q: int
    k0: int
    n_kv: int
    replicated: bool


def head_layout(cfg: LMConfig, tp: int, rank: int) -> HeadLayout:
    """The heads rank ``rank`` of ``tp`` computes (see the module's
    docstring for the replicated route)."""
    H, Kh, G = cfg.n_heads, cfg.n_kv_heads, cfg.group_size
    if H % tp:
        return HeadLayout(0, H, 0, Kh, True)
    n_q = H // tp
    if n_q % G and G % n_q:
        raise ValueError(f"{cfg.name}: {n_q} query heads a rank do not "
                         f"tile groups of {G}")
    h0 = rank * n_q
    k0 = h0 // G
    return HeadLayout(h0, n_q, k0, (h0 + n_q - 1) // G + 1 - k0, False)


def _rank_heads(cfg: LMConfig, rules) -> HeadLayout:
    """This rank's heads; every head without a mesh."""
    if not on_mesh(rules):
        return head_layout(cfg, 1, 0)
    mesh = rules.mesh
    return head_layout(cfg, col.axis_size(mesh, rules.tp),
                       col.axis_index(mesh, rules.tp))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def dense_ffn(cfg: LMConfig, lp: dict, x: torch.Tensor,
              rules=None) -> torch.Tensor:
    """The gated FFN; on a mesh column-parallel ``wi_*`` (their ``d`` rows
    gathered over ``fsdp``), row-parallel ``wo_ffn`` and a ``psum`` over
    ``tp``."""
    act = ACTIVATIONS[cfg.act]
    x = _vary(x, rules)
    h = act(x @ _fsdp(lp["wi_gate"], rules, 0)) * (
        x @ _fsdp(lp["wi_up"], rules, 0))
    return _tp_sum(h @ _fsdp(lp["wo_ffn"], rules, 1), rules)


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


def expert_parallel(cfg: LMConfig, rules) -> bool:
    """The reference's ``use_smap``: a mesh holding ``rules.tp`` whose size
    divides ``n_experts``."""
    mesh = None if rules is None else rules.mesh
    return (mesh is not None and rules.tp in tuple(mesh.mesh_dim_names)
            and cfg.n_experts % col.axis_size(mesh, rules.tp) == 0)


def moe_ffn(cfg: LMConfig, lp: dict, x: torch.Tensor, train: bool = False,
            rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN: (y, aux) of :func:`_moe_core`.

    Without the expert-parallel route (:func:`expert_parallel`) it is the
    reference's single-shard branch, all experts here. On the route (the
    reference's ``shard_map`` body): ``x`` [B_l, S, D] is this rank's rows
    and the expert leaves are this rank's slice of the reference's
    layouts ``(tp, fsdp, None)`` / ``(tp, None, fsdp)``; with
    ``rules.fsdp`` set they are all-gathered over it (``wi_gate`` and
    ``wi_up`` on axis 1, ``wo_ffn`` on 2), and so is the router's ``d``
    rows (``param_shardings``: ``(fsdp, None)``). The rank computes experts
    [e0, e0 + El), ``e0 = axis_index(tp) * El``, and a ``psum`` over
    ``tp`` combines the slices; ``aux`` is ``pmean``ed over the batch
    axes. The tokens and the router, replicated over ``tp``, enter
    through ``pvary`` (their gradient summed over ``tp``, as JAX types
    them), and ``aux``, the same on every ``tp`` rank, is ``pmean``ed over
    ``tp`` too, which leaves its value and gives each rank its share of
    the gradient."""
    if not expert_parallel(cfg, rules):
        return _moe_core(cfg, lp["router"], lp["wi_gate"], lp["wi_up"],
                         lp["wo_ffn"], x, 0, train)
    mesh, tp = rules.mesh, rules.tp
    wig, wiu = _fsdp(lp["wi_gate"], rules, 1), _fsdp(lp["wi_up"], rules, 1)
    wof = _fsdp(lp["wo_ffn"], rules, 2)
    router = _fsdp(lp["router"], rules, 0)
    El = cfg.n_experts // col.axis_size(mesh, tp)
    e0 = col.axis_index(mesh, tp) * El
    y, aux = _moe_core(cfg, col.pvary(router, mesh, tp), wig, wiu, wof,
                       col.pvary(x, mesh, tp), e0, train)
    y = col.psum(y, mesh, tp)
    return y, col.pmean(aux, mesh, (*rules.batch, tp))


def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor,
           rules=None) -> torch.Tensor:
    """Token embeddings; on a mesh vocabulary-parallel: a masked lookup
    into the rank's [V/tp, d] rows (``d`` gathered over ``fsdp``), then a
    ``psum`` over ``tp``."""
    if not on_mesh(rules):
        x = params["embed"][tokens]
    else:
        emb = _fsdp(params["embed"], rules, 1)
        n = emb.shape[0]
        local = tokens.long() - col.axis_index(rules.mesh, rules.tp) * n
        mine = (local >= 0) & (local < n)
        x = _tp_sum(emb[local.clamp(0, n - 1)]
                    * mine[..., None].to(emb.dtype), rules)
    if cfg.scale_embed:     # the factor rounded to x's dtype, as in JAX
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def _qkv(cfg: LMConfig, lp: dict, h: torch.Tensor, rot: tuple,
         rules=None, all_kv: bool = False):
    """Projections, qk norms and rotary embeddings (``rot`` = the pass's
    :func:`rope_tables`): [B, S, heads, dh]. On a mesh the rank's query
    heads (:func:`head_layout`) and its kv heads, or every kv head with
    ``all_kv`` (a cache write)."""
    B, S, _ = h.shape
    dh = cfg.d_head
    lay = _rank_heads(cfg, rules)
    with spans.span("qkv"):
        h = _vary(h, rules)
        wq = _fsdp(lp["wq"], rules, 0)
        if lay.replicated:
            wq = col.all_gather(wq, rules.mesh, rules.tp, dim=1)
        wk = _fsdp(_vary(lp["wk"], rules), rules, 0)
        wv = _fsdp(_vary(lp["wv"], rules), rules, 0)
        if not all_kv:
            cols = slice(lay.k0 * dh, (lay.k0 + lay.n_kv) * dh)
            wk, wv = wk[:, cols], wv[:, cols]
        q = (h @ wq).view(B, S, -1, dh)
        k = (h @ wk).view(B, S, -1, dh)
        v = (h @ wv).view(B, S, -1, dh)
    with spans.span("qk_norm_rope"):
        qs = ks = None
        if cfg.qk_norm:
            qs, ks = _vary(lp["q_norm"], rules), _vary(lp["k_norm"], rules)
        fused = (norm.norm_rope if norm.takes_norm_rope(q, k, qs, ks, *rot)
                 else norm.norm_rope_reference)
        return (*fused(q, k, qs, ks, *rot, cfg.qk_norm), v)


def _attn_out(cfg: LMConfig, lp: dict, flat: torch.Tensor,
              rules=None) -> torch.Tensor:
    """The output projection of attention [B, S, heads * dh]; on a mesh
    row-parallel: the rank's heads (or, on the replicated route, the
    rank's rows of every head's output) times its ``wo`` rows, ``psum``
    over ``tp``."""
    wo = _fsdp(lp["wo"], rules, 1)
    if _rank_heads(cfg, rules).replicated:
        n = wo.shape[0]
        r = col.axis_index(rules.mesh, rules.tp)
        flat = flat[..., r * n:(r + 1) * n]
    return _tp_sum(flat @ wo, rules)


def _residual(cfg: LMConfig, lp: dict, x: torch.Tensor,
              attn: torch.Tensor, train: bool = False, rules=None
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Output projection, then the FFN half of the layer: (x, the MoE
    aux loss, None for a dense FFN)."""
    with spans.span("attn_out"):
        attn = _attn_out(cfg, lp, attn.reshape(*x.shape[:2], -1), rules)
        if cfg.sandwich_norm:
            attn = rms_norm(attn, lp["ln_attn_post"])
        x = x + attn
    with spans.span("ffn_norm"):
        h = rms_norm(x, lp["ln_mlp"])
    with spans.span("ffn"):
        if cfg.moe:
            out, aux = moe_ffn(cfg, lp, h, train, rules)
        else:
            out, aux = dense_ffn(cfg, lp, h, rules), None
        if cfg.sandwich_norm:
            out = rms_norm(out, lp["ln_mlp_post"])
        return x + out, aux


def _logits(cfg: LMConfig, params: dict, x: torch.Tensor,
            train: bool = False, rules=None) -> torch.Tensor:
    """Final norm, head and softcap: [B, S, V_padded], or on a mesh the
    rank's vocabulary shard [B, S, V_padded / tp]."""
    x = _vary(rms_norm(x, params["final_norm"]), rules)
    head = (_fsdp(params["embed"], rules, 1).T if cfg.tie_embeddings
            else _fsdp(params["lm_head"], rules, 0))
    logits = x @ head
    if cfg.final_softcap is not None:
        cap = cfg.final_softcap
        if train:
            return torch.tanh(logits / cap) * cap
        # in place when serving: prefill logits are large
        logits.div_(cap).tanh_().mul_(cap)
    return logits


def _layer(cfg: LMConfig, lp: dict, x: torch.Tensor, window: int,
           rot: tuple, kv_out: tuple | None = None, train: bool = False,
           rules=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One prefill layer, (x, aux) as :func:`_residual`; ``kv_out`` =
    (k_cache, v_cache, base): [B, S_l, Kh, dh] views of one layer's cache
    (this rank's positions [base, base + S_l) on a mesh), written where
    they meet [0, S). ``train``: attention through :class:`FlashAttention`
    and every op out of place."""
    mesh_cache = kv_out is not None and on_mesh(rules)
    with spans.span("attn_norm"):
        h = rms_norm(x, lp["ln_attn"])
    q, k, v = _qkv(cfg, lp, h, rot, rules, all_kv=mesh_cache)
    del h
    if train:
        attn = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), window,
                                    cfg.attn_softcap or 0.0)
        return _residual(cfg, lp, x, attn.transpose(1, 2), True, rules)
    if kv_out is not None:
        with spans.span("kv_write"):
            kc, vc, base = kv_out
            lo, hi = max(base, 0), min(base + kc.shape[1], x.shape[1])
            if hi > lo:
                kc[:, lo - base:hi - base] = k[:, lo:hi]
                vc[:, lo - base:hi - base] = v[:, lo:hi]
    with spans.span("attention"):
        if mesh_cache:          # the rank's kv heads, from all of them
            lay = _rank_heads(cfg, rules)
            k = k[:, :, lay.k0:lay.k0 + lay.n_kv]
            v = v[:, :, lay.k0:lay.k0 + lay.n_kv]
        attn = torch.empty_like(q)                       # [B, S, H, dh]
        flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), window=window,
                        softcap=cfg.attn_softcap or 0.0,
                        out=attn.transpose(1, 2))
    return _residual(cfg, lp, x, attn, rules=rules)


# ---------------------------------------------------------------------------
# forward and serving
# ---------------------------------------------------------------------------

@torch.no_grad()
def lm_forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
               rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V_padded], aux_loss): the MoE
    layers' mean Switch aux loss, 0 for a dense config. Runs on the
    params' device; under a mesh (``rules``) on this rank's tokens and
    pieces of the weights, returning the rank's vocabulary shard [B, S,
    V_padded / tp]."""
    return _forward(cfg, params, tokens, None, rules=rules)


def _forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
             cache: dict | None, train: bool = False, rules=None,
             seq_shard: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    B, S = tokens.shape
    with spans.span("embed"):
        x = _embed(cfg, params, tokens, rules)
        rot = rope_tables(torch.arange(S, device=x.device).expand(B, S),
                          cfg.d_head, cfg.rope_theta)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    base = 0
    if cache is not None and on_mesh(rules):
        base = cache["k"].shape[2] * col.axis_index(
            rules.mesh, cache_axes(rules, seq_shard))
    for layer, window in enumerate(cfg.layer_windows().tolist()):
        lp = layer_params(params, layer)
        if train:   # rematted: the backward recomputes the layer
            x, aux_l = checkpoint(_layer, cfg, lp, x, window, rot, None,
                                  True, rules, use_reentrant=False)
        else:
            kv = None if cache is None else (cache["k"][layer],
                                             cache["v"][layer], base)
            x, aux_l = _layer(cfg, lp, x, window, rot, kv, rules=rules)
        if aux_l is not None:
            aux = aux + aux_l
    with spans.span("logits"):
        logits = _logits(cfg, params, x, train, rules)
    return logits, aux / cfg.n_layers


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                        rules) -> torch.Tensor:
    """Per-token NLL [N] of float32 logits [N, V/tp], this rank's
    vocabulary shard: the row max ``pmax``ed over ``tp`` (detached: it has
    no gradient), the sum of exponentials and the target's logit (gathered
    where the target lies in this shard) ``psum``med over ``tp``."""
    n = logits.shape[-1]
    m = col.pmax(logits.max(dim=-1).values, rules.mesh, rules.tp)
    total = _tp_sum(torch.exp(logits - m[:, None]).sum(dim=-1), rules)
    local = labels - col.axis_index(rules.mesh, rules.tp) * n
    mine = (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[:, None])[:, 0]
    picked = _tp_sum(picked * mine, rules)
    return torch.log(total) + m - picked


def lm_loss(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            rules=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy over [B, S] tokens (the reference's
    ``lm_loss``): the mean NLL of tokens 1..S-1 from the float32 logits of
    positions 0..S-2, plus ``aux_loss_weight`` times the MoE layers' mean
    aux loss. Returns (loss, {"nll", "aux"}), 0-dim float32 tensors with a
    gradient to every leaf of ``params`` that requires one.

    Under a mesh (``rules``), ``tokens`` are this rank's rows and the
    params its pieces: the cross-entropy is vocabulary-parallel
    (:func:`_vocab_parallel_nll`), the NLL's sum is ``psum``med over the
    batch axes and divided by every rank's token count, so each rank
    returns the whole loss and each leaf gets this rank's share of its
    gradient (``make_train_step(..., specs=)`` sums the shares)."""
    logits, aux = _forward(cfg, params, tokens, None, train=True,
                           rules=rules)
    lg = logits[:, :-1].float().flatten(0, 1)
    labels = tokens[:, 1:].flatten().long()
    if not on_mesh(rules):
        nll = torch.nn.functional.cross_entropy(lg, labels)
    else:
        nll = _vocab_parallel_nll(lg, labels, rules).sum()
        shards = 1
        if rules.batch:
            nll = col.psum(nll, rules.mesh, rules.batch)
            shards = col.axis_size(rules.mesh, rules.batch)
        nll = nll / (labels.numel() * shards)
    loss = nll + cfg.aux_loss_weight * aux
    return loss, {"nll": nll, "aux": aux}


@torch.no_grad()
def lm_prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor,
               cache: dict | None = None, rules=None,
               seq_shard: bool = False) -> torch.Tensor:
    """Prefill pass: logits [B, S, V_padded]. With ``cache`` (from
    :func:`init_kv_cache`, ``S_max >= S``) each layer's K/V are written in
    place at positions [0, S), so decoding can go on from position S; the
    JAX prefill returns logits only. Under a mesh (``rules``), as
    :func:`lm_forward`; the cache is this rank's piece of
    :func:`cache_shardings` (``seq_shard`` as there), and the rank writes
    the positions it holds."""
    held = cache["k"].shape[2] if cache is not None else None
    if on_mesh(rules) and cache is not None:
        held *= col.axis_size(rules.mesh, cache_axes(rules, seq_shard))
    if cache is not None and held < tokens.shape[1]:
        raise ValueError(f"cache holds {held} positions, "
                         f"prompt has {tokens.shape[1]}")
    with spans.root("prefill", tokens.device):
        return _forward(cfg, params, tokens, cache, rules=rules,
                        seq_shard=seq_shard)[0]


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
                   tokens: torch.Tensor, pos: int | torch.Tensor,
                   rules=None, seq_shard: bool = False
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
    the caller keeps it in range.

    Under a mesh (``rules``) the cache is this rank's piece of
    :func:`cache_shardings` (``seq_shard`` as there) and the logits the
    rank's vocabulary shard (:func:`_decode_step_mesh`); ``pos`` must be
    an int there (the rank's view of its slice is cut on the host), and a
    tensor raises ``ValueError``."""
    if on_mesh(rules):
        if isinstance(pos, torch.Tensor):
            raise ValueError("lm_decode_step on a mesh takes an int pos: "
                             "each rank cuts its slice's visible range on "
                             "the host")
        return _decode_step_mesh(cfg, params, cache, tokens, int(pos),
                                 rules, seq_shard)
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


def shard_range(pos: int, window: int, base: int, held: int
                ) -> tuple[int, int]:
    """[a, b): the positions of a slice [base, base + held) that decoding
    at ``pos`` sees (the global range [max(0, pos + 1 - window) if window
    else 0, pos + 1)), in the slice's coordinates, clamped to [0,
    held)."""
    lo = max(0, pos + 1 - window) if window else 0
    a = min(max(lo - base, 0), held)
    b = min(max(pos + 1 - base, 0), held)
    return a, max(a, b)


def owner_slot(pos: int, base: int, held: int) -> int | None:
    """The slot of ``pos`` in a slice [base, base + held), None where the
    slice does not hold it (and so writes nothing)."""
    return pos - base if base <= pos < base + held else None


def attend_shard(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 a: int, b: int, softcap: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, H, dh] against one slice of a layer's cache, kc/vc [B, S_l,
    Kh, dh], its positions [a, b) visible: (out [B, H, dh] float32, lse
    [B, H] float32). ``decode_attention`` runs on the whole slice with
    lengths ``b`` and a window of ``b - a``: the keys of the view [a, b)
    without a window, read alone, under the slice's own chunk plan
    whatever ``a`` is (a world of one decodes bit for bit the call
    without a mesh, local layers too). It writes its output unrounded, in
    float32, so the combine rounds once; an empty range launches nothing
    and gives zeros and an lse of -inf."""
    B, H, _ = q.shape
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if b <= a:
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                lse.fill_(float("-inf")))
    lengths = torch.full((B,), b, dtype=torch.int32, device=q.device)
    out = decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                           lengths, b - a, softcap, lse=lse,
                           out_dtype=torch.float32)
    return out, lse


def lse_combine(out: torch.Tensor, lse: torch.Tensor, pmax, psum,
                dtype: torch.dtype) -> torch.Tensor:
    """The attention over every slice from each slice's float32 (out,
    lse): ``m = pmax(lse)``, ``psum(out * exp(lse - m)) / psum(exp(lse -
    m))`` in float32, rounded once to ``dtype``; ``pmax`` and ``psum``
    reduce over the slices (collectives over the cache's axes on a
    mesh)."""
    w = torch.exp(lse - pmax(lse))
    num = psum(out * w[..., None])
    return (num / psum(w)[..., None]).to(dtype)


def _decode_step_mesh(cfg: LMConfig, params: dict, cache: dict,
                      tokens: torch.Tensor, pos: int, rules,
                      seq_shard: bool) -> tuple[torch.Tensor, dict]:
    """:func:`lm_decode_step` on a sequence-sharded cache: the rank holds
    positions [base, base + S_l), ``base = axis_index(cache axes) * S_l``,
    and writes the new K/V only if it holds ``pos``. Each layer: the
    rank's query heads, all-gathered over ``tp`` (every head, [B, H,
    dh]); :func:`attend_shard` over the rank's visible slice for every
    head; :func:`lse_combine` over the cache's axes; the rank's heads'
    rows into the row-parallel ``wo``."""
    mesh = rules.mesh
    axes = cache_axes(rules, seq_shard)
    held = cache["k"].shape[2]
    base = col.axis_index(mesh, axes) * held
    if not 0 <= pos < held * col.axis_size(mesh, axes):
        raise ValueError(f"pos {pos} is outside the cache's "
                         f"[0, {held * col.axis_size(mesh, axes)}) "
                         f"positions")
    B = tokens.shape[0]
    x = _embed(cfg, params, tokens, rules)
    pos_t = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    rot = rope_tables(pos_t.expand(B, 1), cfg.d_head, cfg.rope_theta)
    slot = owner_slot(pos, base, held)
    at = torch.full((1,), slot or 0, dtype=torch.int64, device=x.device)
    lay = _rank_heads(cfg, rules)
    softcap = cfg.attn_softcap or 0.0

    def pmax(t):
        return col.pmax(t, mesh, axes)

    def psum(t):
        return col.psum(t, mesh, axes)

    for layer, window in enumerate(cfg.layer_windows().tolist()):
        lp = layer_params(params, layer)
        q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln_attn"]), rot, rules,
                       all_kv=True)
        kc, vc = cache["k"][layer], cache["v"][layer]   # [B, S_l, Kh, dh]
        if slot is not None:
            kc.index_copy_(1, at, k.to(kc.dtype))
            vc.index_copy_(1, at, v.to(vc.dtype))
        q = q[:, 0]
        if not lay.replicated:
            q = col.all_gather(q, mesh, rules.tp, dim=1)   # [B, H, dh]
        out, lse = attend_shard(q, kc, vc,
                                *shard_range(pos, window, base, held),
                                softcap)
        attn = lse_combine(out, lse, pmax, psum, q.dtype)
        if not lay.replicated:
            attn = attn[:, lay.h0:lay.h0 + lay.n_q]
        x = _residual(cfg, lp, x, attn, rules=rules)[0]
    return _logits(cfg, params, x, rules=rules), cache
