"""Plain torch versions of the CUDA kernels (the ``ref.py`` contract).

Each function is the definition with no blocking: the wrappers use them
for tensors on the CPU, the tests hold them against the JAX package's
kernels, and ``chip_smoke.py`` holds every CUDA kernel against them on the
card. The query kernels' results are int32, like the kernels'; the
attention, segment-sum and embedding-bag results take their input's dtype,
computed in float32.
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

    Dense softmax attention in float32: scale ``d ** -0.5``, softcap
    ``tanh(s / c) * c``, masked scores -1e30, key k visible to query q when
    ``k <= q`` (causal) and ``k > q - window`` (window > 0). Computed over
    chunks of query rows so the scores stay under 1 GiB; the result is
    the same. Returns q's dtype."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kpos = torch.arange(S, device=q.device)[None, :]
    step = max(1, _SCORE_ELEMS // max(1, B * H * S))
    for q0 in range(0, S, step):
        qc = q[:, :, q0:q0 + step].float()
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


def decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q [B,H,d]; caches [B,Hkv,S,d]; lengths [B] (valid prefix, including
    the current position). Keys ``k < length`` are visible, and with
    window > 0 only ``k >= length - window``. A sequence with no visible
    key gives zeros, as the kernels' 1e-30 denominator does."""
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
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    p = p * valid.any(dim=-1, keepdim=True)
    return torch.einsum("bhk,bhkd->bhd", p, vf).to(q.dtype)


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
