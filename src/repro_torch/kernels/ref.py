"""Plain torch versions of the query kernels (the ``ref.py`` contract).

Each function is the definition with no blocking: the wrappers use them
for tensors on the CPU, the tests hold them against the JAX package's
kernels, and ``chip_smoke.py`` holds every CUDA kernel against them on the
card. All results are int32, like the kernels'.
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
