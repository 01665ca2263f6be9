"""Sorted-probe join: the device side of the matcher's presorted join.

Wrappers of the ``probe_sorted`` and ``scan_probe`` CUDA kernels in
``csrc/rdf_kernels.cu`` (ports of ``repro/kernels/join_probe.py``). For
every probe value ``v`` against ascending keys, ``lo = #(keys < v)`` and
``hi = #(keys <= v)``, bit-identical to ``np.searchsorted`` left/right.
A tensor on the CPU takes the plain torch version in :mod:`.ref`; a tensor
on the card launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from . import ref
from ._build import check_int32, launch
from .triple_scan import _pattern


def probe_sorted_many(keys: torch.Tensor, probes: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """keys [K] int32 ascending, probes [Q, P] int32 -> (lo, hi) [Q, P].

    ``-1`` probes give ``lo == hi == 0`` against non-negative keys."""
    check_int32("keys", keys, 1)
    check_int32("probes", probes, 2, device=keys.device)
    if keys.device.type == "cpu":
        return ref.probe_sorted_reference(keys, probes)
    lo = torch.empty(probes.shape, dtype=torch.int32, device=keys.device)
    hi = torch.empty_like(lo)
    n = probes.numel()
    if n:
        launch("probe_sorted_many", keys.device, keys.data_ptr(),
               keys.shape[0], probes.data_ptr(), n, lo.data_ptr(),
               hi.data_ptr())
    return lo, hi


def probe_sorted(keys: torch.Tensor, probes: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """keys [K] ascending, probes [P] -> (lo [P], hi [P])."""
    check_int32("probes", probes, 1, device=keys.device)
    lo, hi = probe_sorted_many(keys, probes[None, :])
    return lo[0], hi[0]


def scan_probe(triples: torch.Tensor, pattern: Sequence[int],
               keys: torch.Tensor, col: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused candidate scan + first-join probe in one launch.

    triples [T, 3] int32; pattern (s, p, o) host ints (-1 == wildcard);
    keys [K] int32 ascending; ``col`` is the probe column (0 = subject,
    2 = object). Returns ``(mask, lo, hi)``, each [T] int32: the scan mask
    and the searchsorted bounds of EVERY row's probe-column value.
    """
    if col not in (0, 2):
        raise ValueError(f"col must be 0 (subject) or 2 (object), got {col}")
    check_int32("triples", triples, 2)
    check_int32("keys", keys, 1, device=triples.device)
    if triples.shape[1] != 3:
        raise ValueError(f"triples must be [T, 3], got {tuple(triples.shape)}")
    s, p, o = _pattern(pattern)
    if triples.device.type == "cpu":
        return ref.scan_probe_reference(triples, s, p, o, keys, col)
    T = triples.shape[0]
    mask = torch.empty(T, dtype=torch.int32, device=triples.device)
    lo = torch.empty_like(mask)
    hi = torch.empty_like(mask)
    if T:
        launch("scan_probe", triples.device, triples.data_ptr(), T, s, p, o,
               keys.data_ptr(), keys.shape[0], col, mask.data_ptr(),
               lo.data_ptr(), hi.data_ptr())
    return mask, lo, hi
