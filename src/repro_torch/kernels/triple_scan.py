"""Triple-pattern scan: the candidate-scan hot spot of BGP matching.

Wrappers of the ``triple_scan`` and ``triple_scan_many`` CUDA kernels in
``csrc/rdf_kernels.cu`` (ports of ``repro/kernels/triple_scan.py``). A
tensor on the CPU takes the plain torch version in :mod:`.ref`; a tensor on
the card launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from . import ref
from ._build import check_int32, launch


def _pattern(pattern: Sequence[int]) -> tuple[int, int, int]:
    s, p, o = (int(x) for x in pattern)
    return s, p, o


def triple_scan(triples: torch.Tensor,
                pattern: Sequence[int]) -> torch.Tensor:
    """triples [T, 3] int32; pattern (s, p, o) host ints, -1 == wildcard.

    Returns the int32 match mask [T] on the triples' device."""
    check_int32("triples", triples, 2)
    if triples.shape[1] != 3:
        raise ValueError(f"triples must be [T, 3], got {tuple(triples.shape)}")
    s, p, o = _pattern(pattern)
    if triples.device.type == "cpu":
        return ref.triple_scan_reference(triples, s, p, o)
    T = triples.shape[0]
    mask = torch.empty(T, dtype=torch.int32, device=triples.device)
    if T:
        launch("triple_scan", triples.device, triples.data_ptr(), T, s, p, o,
               mask.data_ptr())
    return mask


def triple_scan_many(triples: torch.Tensor,
                     patterns: torch.Tensor) -> torch.Tensor:
    """Masks of Q patterns in one launch: triples [T, 3], patterns [Q, 3]
    int32 on the same device (-1 == wildcard) -> [Q, T] int32."""
    check_int32("triples", triples, 2)
    check_int32("patterns", patterns, 2, device=triples.device)
    if triples.shape[1] != 3 or patterns.shape[1] != 3:
        raise ValueError("triples and patterns must both be [*, 3], got "
                         f"{tuple(triples.shape)} and {tuple(patterns.shape)}")
    if triples.device.type == "cpu":
        return ref.triple_scan_many_reference(triples, patterns)
    T, Q = triples.shape[0], patterns.shape[0]
    mask = torch.empty((Q, T), dtype=torch.int32, device=triples.device)
    if T and Q:
        launch("triple_scan_many", triples.device, triples.data_ptr(), T,
               patterns.data_ptr(), Q, mask.data_ptr())
    return mask
