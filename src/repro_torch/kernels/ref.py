"""Plain torch versions of the CUDA kernels (the ``ref.py`` contract).

Each function is the definition with no blocking: the wrappers use them
for tensors on the CPU, the tests hold them against the JAX package's
kernels, and ``chip_smoke.py`` holds every CUDA kernel against them on the
card. The query kernels' results are int32, like the kernels'; the
attention, segment-sum and embedding-bag results take their input's dtype,
computed in float32. The training kernels' plain versions are here too:
the attention backward (autograd through :func:`mha_reference`) and the
bag's table gradient (``zeros`` + ``index_add_``).
"""

from __future__ import annotations

import torch


def triple_scan_reference(triples: torch.Tensor, s: int, p: int,
                          o: int) -> torch.Tensor:
    """triples [T, 3] int32; s/p/o pattern ids, negative == wildcard.

    Returns int32 match mask [T]."""
    m = torch.ones(triples.shape[0], dtype=torch.bool, device=triples.device)
    if s >= 0:
        m &= triples[:, 0] == s
    if p >= 0:
        m &= triples[:, 1] == p
    if o >= 0:
        m &= triples[:, 2] == o
    return m.to(torch.int32)


def triple_scan_many_reference(triples: torch.Tensor,
                               patterns: torch.Tensor) -> torch.Tensor:
    """triples [T, 3]; patterns [Q, 3] (negative == wildcard) -> [Q, T]."""
    rows = [triple_scan_reference(triples, *pat)
            for pat in patterns.tolist()]
    if not rows:
        return torch.zeros((0, triples.shape[0]), dtype=torch.int32,
                           device=triples.device)
    return torch.stack(rows)


def probe_sorted_reference(keys: torch.Tensor, probes: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """keys [K] sorted ascending; probes of any shape -> (lo, hi), the
    searchsorted left/right bounds (the matcher's ``np.searchsorted``)."""
    keys = keys.contiguous()
    probes = probes.contiguous()
    lo = torch.searchsorted(keys, probes, out_int32=True)
    hi = torch.searchsorted(keys, probes, right=True, out_int32=True)
    return lo, hi


def scan_probe_reference(triples: torch.Tensor, s: int, p: int, o: int,
                         keys: torch.Tensor, col: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan mask plus searchsorted bounds of every row's probe-column value
    (col 0 = subject, 2 = object)."""
    mask = triple_scan_reference(triples, s, p, o)
    lo, hi = probe_sorted_reference(keys, triples[:, col])
    return mask, lo, hi


# ---------------------------------------------------------------------------
# attention (the LM serving path)
# ---------------------------------------------------------------------------

# Score elements one query chunk of mha_reference may hold (1 GiB in f32):
# the definition is dense, but a 32k prefill's [H, S, S] scores are not.
_SCORE_ELEMS = 1 << 28
NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,S,d]; k/v [B,Hkv,S,d] (query head h reads kv head h // G).

    Dense softmax attention in float32 (float64 for float64 inputs, the
    float32 checks' exact yardstick): scale ``d ** -0.5``, softcap
    ``tanh(s / c) * c``, masked scores -1e30, key k visible to query q when
    ``k <= q`` (causal) and ``k > q - window`` (window > 0). Computed over
    chunks of query rows so the scores stay under 1 GiB of float32; the
    result is the same. Returns q's dtype."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(acc).repeat_interleave(G, dim=1)
    vf = v.to(acc).repeat_interleave(G, dim=1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kpos = torch.arange(S, device=q.device)[None, :]
    step = max(1, _SCORE_ELEMS // max(1, B * H * S))
    for q0 in range(0, S, step):
        qc = q[:, :, q0:q0 + step].to(acc)
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * (d ** -0.5)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        qpos = torch.arange(q0, q0 + qc.shape[2], device=q.device)[:, None]
        mask = torch.ones((qc.shape[2], S), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
        out[:, :, q0:q0 + step] = torch.einsum("bhqk,bhkd->bhqd", p,
                                               vf).to(q.dtype)
    return out


def mha_lse_reference(q: torch.Tensor, k: torch.Tensor, window: int = 0,
                      softcap: float = 0.0) -> torch.Tensor:
    """The row log-sum-exp [B, H, S] (float32, natural log) of
    :func:`mha_reference`'s scaled, capped, masked scores: what the
    forward kernels write for the backward. Chunked over query rows like
    :func:`mha_reference`."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    out = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    kpos = torch.arange(S, device=q.device)[None, :]
    step = max(1, _SCORE_ELEMS // max(1, B * H * S))
    for q0 in range(0, S, step):
        qc = q[:, :, q0:q0 + step].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * (d ** -0.5)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        qpos = torch.arange(q0, q0 + qc.shape[2], device=q.device)[:, None]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        out[:, :, q0:q0 + step] = torch.logsumexp(
            s.masked_fill(~mask, float("-inf")), dim=-1)
    return out


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        dout: torch.Tensor, window: int = 0, softcap: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of causal :func:`mha_reference` for the output
    gradient ``dout``: autograd through the plain forward in float32 (its
    inputs cast up, the cotangent too), each gradient rounded once to its
    input's dtype."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        o = mha_reference(qf, kf, vf, True, window, softcap)
        dq, dk, dv = torch.autograd.grad(o, (qf, kf, vf), dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The float32 tensor-core routes (csrc/flash_f32_tc.cu, flash_bwd_f32_tc.cu)
# take each product a.b as bf16 products of three-piece splits (split3):
# the six (piece of a, piece of b) pairs below, 0 = hi, 1 = mid, 2 = lo,
# smallest first as the kernels issue them. The three dropped pairs (mid.lo,
# lo.mid, lo.lo) sum to at most about 2^-23 |a||b|, a float32 rounding of
# the product. TWO_PIECE_TERMS is the control one piece short: hi.hi +
# hi.mid + mid.hi.
SPLIT_TERMS = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))
TWO_PIECE_TERMS = ((1, 0), (0, 1), (0, 0))
_LOG2E = 1.4426950408889634


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """float32 x -> bf16 (hi, mid, lo): hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid). For normal x, hi + mid + lo == x exactly:
    each subtraction is exact in float32, and the last remainder has at
    most 7 significant bits."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def split_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                  terms=SPLIT_TERMS) -> torch.Tensor:
    """``einsum(eq, a, b)`` as the float32 routes' tensor cores take it: the
    sum, in float32, of the products of the ``terms`` pairs of
    :func:`split3` pieces (each bf16 product exact in float32)."""
    pa = [p.float() for p in split3(a)]
    pb = [p.float() for p in split3(b)]
    out = torch.einsum(eq, pa[terms[0][0]], pb[terms[0][1]])
    for i, j in terms[1:]:
        out += torch.einsum(eq, pa[i], pb[j])
    return out


def _visible(S: int, window: int, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


def mha_split_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0, softcap: float = 0.0,
                        key_tile: int = 64, terms=SPLIT_TERMS
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 tensor-core forward's arithmetic on float32 q [B,H,S,d]
    and k/v [B,Hkv,S,d] -> (out [B,H,S,d], lse [B,H,S]): key tiles of
    ``key_tile``, S = Q K^T by :func:`split_product`, the online softmax in
    log2 units with l summed over the unrounded p, P V with P split in
    three as well. ``terms`` of :data:`TWO_PIECE_TERMS` gives the control
    one piece short. Dense over the rows; small S."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    scale = d ** -0.5
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S, 1), -float("inf"), device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    o = torch.zeros((B, H, S, d), device=q.device)
    for k0 in range(0, S, key_tile):
        s = split_product("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + key_tile],
                          terms)
        if softcap > 0:
            x = torch.tanh(s * scale * (1.0 / softcap)) * softcap * _LOG2E
        else:
            x = s * (scale * _LOG2E)
        keys = torch.arange(k0, min(S, k0 + key_tile), device=q.device)
        dead = keys[None, :] > rows
        if window > 0:
            dead |= keys[None, :] <= rows - window
        x = x.masked_fill(dead, -float("inf"))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -float("inf"), 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        o = o * alpha + split_product("bhqk,bhkd->bhqd", p,
                                      vf[:, :, k0:k0 + key_tile], terms)
    lse = (m + torch.log2(l.clamp(min=1e-30))) / _LOG2E
    return (o / l.clamp(min=1e-30)).to(q.dtype), lse[..., 0]


def mha_split_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        dout: torch.Tensor, lse: torch.Tensor, window: int = 0,
        softcap: float = 0.0, terms=SPLIT_TERMS
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 tensor-core backward's arithmetic -> (dq, dk, dv): S and
    dP = dO V^T by :func:`split_product`, P = 2^(s log2 e - lse log2 e) on
    the mask, Delta = rowsum(dO O) in float32, dS = P (dP - Delta) f (f the
    softcap's factor), then dV = P^T dO, dK = scale dS^T Q and dQ = scale
    dS K with P and dS split in three too, summed over each GQA group.
    Dense over [B, H, S, S]; small S."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = d ** -0.5
    qf, dof = q.float(), dout.float()
    kr = k.float().repeat_interleave(G, dim=1)
    vr = v.float().repeat_interleave(G, dim=1)
    s = split_product("bhqd,bhkd->bhqk", qf, kr, terms)
    f = 1.0
    if softcap > 0:
        t = torch.tanh(s * (scale / softcap))
        x, f = t * (softcap * _LOG2E), 1 - t * t
    else:
        x = s * (scale * _LOG2E)
    p = torch.where(_visible(S, window, q.device),
                    torch.exp2(x - lse.float()[..., None] * _LOG2E), 0.0)
    dp = split_product("bhqd,bhkd->bhqk", dof, vr, terms)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) * f
    dq = split_product("bhqk,bhkd->bhqd", ds, kr, terms) * scale
    dk = split_product("bhqk,bhqd->bhkd", ds, qf, terms).view(
        B, Hkv, G, S, d).sum(2) * scale
    dv = split_product("bhqk,bhqd->bhkd", p, dof, terms).view(
        B, Hkv, G, S, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: int = 0, softcap: float = 0.0,
                     lse: torch.Tensor | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """q [B,H,d]; caches [B,Hkv,S,d]; lengths [B] (valid prefix, including
    the current position) -> [B,H,d] in ``out_dtype`` (q's by default).
    Keys ``k < length`` are visible, and with window > 0 only ``k >=
    length - window``. A sequence with no visible key gives zeros, as the
    kernels' 1e-30 denominator does. ``lse`` (float32 [B, H]) receives the
    log-sum-exp of each row's scaled, softcapped logits over its visible
    keys, -inf where none is."""
    B, H, d = q.shape
    G = H // k_cache.shape[1]
    kf = k_cache.float().repeat_interleave(G, dim=1)
    vf = v_cache.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kf) * (d ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(k_cache.shape[2], device=q.device)[None, None, :]
    n = lengths.to(device=q.device, dtype=torch.int64)[:, None, None]
    valid = kpos < n
    if window > 0:
        valid &= kpos >= n - window
    if lse is not None:
        lse.copy_(torch.logsumexp(s.masked_fill(~valid, float("-inf")),
                                  dim=-1))
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    p = p * valid.any(dim=-1, keepdim=True)
    return torch.einsum("bhk,bhkd->bhd", p, vf).to(out_dtype or q.dtype)


# ---------------------------------------------------------------------------
# sparse aggregation (the GNN and recsys serving paths)
# ---------------------------------------------------------------------------

def segment_sum_sorted_reference(msg: torch.Tensor, dst: torch.Tensor,
                                 n_nodes: int) -> torch.Tensor:
    """msg [E, D]; dst [E] (the kernel's contract sorts it ascending; the
    definition does not need it) -> [n_nodes, D] in msg's dtype, with
    ``out[n] = sum of msg[e] over dst[e] == n`` taken in float32. Edges
    whose dst lies outside [0, n_nodes) are dropped, as the Pallas
    kernel's padding drops them."""
    keep = (dst >= 0) & (dst < n_nodes)
    idx = torch.where(keep, dst.long(), n_nodes)         # n_nodes: dump row
    out = torch.zeros((n_nodes + 1, msg.shape[1]), dtype=torch.float32,
                      device=msg.device)
    out.index_add_(0, idx, msg.float())
    return out[:n_nodes].to(msg.dtype)


def embedding_bag_reference(table: torch.Tensor, ids: torch.Tensor,
                            mask: torch.Tensor,
                            combiner: str = "mean") -> torch.Tensor:
    """table [V, D]; ids / mask [B, F, NNZ] -> [B, F, D] in table's dtype.

    ``sum_z table[ids[z]] * mask[z]`` in float32 (mask cast to float32, as
    the Pallas kernel casts it); ``mean`` divides by
    ``max(sum_z mask[z], 1)``."""
    if combiner not in ("mean", "sum"):
        raise ValueError(f"combiner must be 'mean' or 'sum', got {combiner!r}")
    m = mask.float()
    s = (table[ids.long()].float() * m[..., None]).sum(dim=2)
    if combiner == "mean":
        s = s / m.sum(dim=2).clamp(min=1.0)[..., None]
    return s.to(table.dtype)


def embedding_bag_backward_reference(g: torch.Tensor, ids: torch.Tensor,
                                     mask: torch.Tensor, n_rows: int,
                                     combiner: str = "mean") -> torch.Tensor:
    """The table's gradient [n_rows, D] of :func:`embedding_bag_reference`
    for the output gradient g [B, F, D]: each entry z of a bag adds
    ``g * w_z`` to row ``ids[z]``, ``w_z = mask[z]`` (sum) or
    ``mask[z] / max(sum of the bag's mask, 1)`` (mean), in float32 by
    ``index_add_`` into zeros; the result in g's dtype."""
    if combiner not in ("mean", "sum"):
        raise ValueError(f"combiner must be 'mean' or 'sum', got {combiner!r}")
    m = mask.float()
    w = m / m.sum(dim=2, keepdim=True).clamp(min=1.0) \
        if combiner == "mean" else m
    D = g.shape[-1]
    contrib = g.float()[:, :, None, :] * w[..., None]        # [B, F, NNZ, D]
    out = torch.zeros((n_rows, D), dtype=torch.float32, device=g.device)
    out.index_add_(0, ids.reshape(-1).long(), contrib.reshape(-1, D))
    return out.to(g.dtype)


# ---------------------------------------------------------------------------
# R-QAD (the scheduler's relaxation bound behind B&B)
# ---------------------------------------------------------------------------

QAD_BISECT = 40              # bisection steps of a row projection


def project_rows_reference(x: torch.Tensor, e: torch.Tensor,
                           n_bisect: int = QAD_BISECT) -> torch.Tensor:
    """Project the rows of x onto {d in [0, 1]^K : sum_{k: e_k > 0} d_k <=
    1}: a row whose clipped sum is at most 1 is the clip; otherwise
    ``clip(x - tau, 0, 1)`` with tau found by ``n_bisect`` bisection steps
    on [0, max(x, 0)]."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x = torch.where(e > 0, x, zero)
    y = x.clamp(0.0, 1.0)
    s = y.sum(-1)
    lo = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    hi = x.amax(-1).clamp_min(0.0)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        gt = (x - mid[..., None]).clamp(0.0, 1.0).sum(-1) > 1.0
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    z = (x - hi[..., None]).clamp(0.0, 1.0)
    return torch.where((s <= 1.0)[..., None], y, z)


def qad_solve_reference(A: torch.Tensor, b: torch.Tensor, F: torch.Tensor,
                        e: torch.Tensor, fixed_mask: torch.Tensor,
                        fixed_Ds: torch.Tensor, iters: int) -> torch.Tensor:
    """A, b, e [N, K], F [K], fixed_mask [N] (0 or 1), fixed_Ds [B, N, K],
    all float32 -> [B, N*K + 2] float32: each child's relaxed D (rows
    where ``fixed_mask`` is 1 pinned to its ``fixed_Ds`` rows), then its
    objective f and its Frank-Wolfe certified lower bound lb.

    ``iters`` projected Nesterov steps on f(D) = sum_k (sum_n D_nk A_nk)^2
    / F_k + sum_nk D_nk b_nk with step 1/L, L = 2 max_k sum_n A_nk^2 / F_k;
    then lb = f + sum over free rows of min(0, min_{k: free} g_nk) - g_n.x_n
    (g the gradient at the solution). The arithmetic follows
    ``repro/core/qad.py:solve_rqad`` step for step, in float32."""
    B, N, K = fixed_Ds.shape
    free = (1.0 - fixed_mask)[:, None] * e
    pinned = fixed_mask[:, None] > 0

    def grad(D):
        S = (D * A).sum(-2)
        return (2.0 * A * (S / F)[:, None, :] + b) * free, S

    L = 2.0 * ((A * A).sum(0) / F).amax() + 1e-12
    step = 1.0 / L
    x = project_rows_reference(torch.full_like(A, 0.5) * free, e) * free
    x = x.expand(B, N, K).contiguous()
    x_prev = x
    for t in range(iters):
        beta = float(torch.tensor(float(t)) / (torch.tensor(float(t)) + 3.0))
        y = x + beta * (x - x_prev)
        g, _ = grad(torch.where(pinned, fixed_Ds, y * free))
        x, x_prev = project_rows_reference(y - step * g, e) * free, x
    x = project_rows_reference(x, e) * free
    D = torch.where(pinned, fixed_Ds, x * free)
    g, S = grad(D)
    f = (S * S / F).sum(-1) + (D * b).sum((-2, -1))
    inf = torch.tensor(float("inf"), dtype=g.dtype, device=g.device)
    row_min = torch.where(free > 0, g, inf).amin(-1).clamp_max(0.0)
    row_min = torch.where(torch.isfinite(row_min), row_min,
                          torch.zeros_like(row_min))
    gap = (row_min - (g * x).sum(-1)) * (1.0 - fixed_mask)
    lb = f + gap.sum(-1)
    return torch.cat([D.reshape(B, N * K), f[:, None], lb[:, None]], dim=1)
