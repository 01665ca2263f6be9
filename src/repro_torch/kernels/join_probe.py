"""Sorted-probe join: the device side of the matcher's presorted join.

Wrappers of the ``probe_sorted`` and ``scan_probe`` CUDA kernels in
``csrc/rdf_kernels.cu`` (ports of ``repro/kernels/join_probe.py``). For
every probe value ``v`` against ascending keys, ``lo = #(keys < v)`` and
``hi = #(keys <= v)``, bit-identical to ``np.searchsorted`` left/right.
A tensor on the CPU takes the plain torch version in :mod:`.ref`; a tensor
on the card launches the kernel or raises — it never falls back.

``scan_probe`` searches in two levels: every ``stride``-th key sits in
shared memory (at most SAMPLE_MAX of them, gathered once per call into a
scratch buffer), and a search there leaves a window of ``stride - 1``
keys in device memory. :func:`probe_plan` picks
the stride and the grid from the shapes; the launcher takes them as they
are.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

import torch

from . import ref
from ._build import check_int32, launch
from .decode_attention import SMS
from .triple_scan import _pattern

SAMPLE_MAX = 32768           # keys of the shared-memory sample (128 KB)
PROBE_SPAN = 12              # window keys the 16-byte loads finish
PROBE_THREADS = 1024         # threads of a block (the kernel's
                             # kProbeThreads)
PROBE_ROWS = 4               # consecutive rows a thread takes
PROBE_BLOCKS_PER_SM = 1      # blocks of the persistent grid on each SM


class ProbePlan(NamedTuple):
    stride: int     # keys[0], keys[stride], ... form the sample
    n_samples: int  # ceil(K / stride), at most SAMPLE_MAX; 0 for no keys
    vec: bool       # rows read as 16-byte loads (triples 16-byte aligned)
    blocks: int     # the persistent grid


def probe_plan(T: int, K: int, aligned: bool) -> ProbePlan:
    """The sample and grid of ``scan_probe`` over T rows and K keys:
    the smallest stride that keeps the sample within SAMPLE_MAX keys
    (stride 1, the whole array, when K <= SAMPLE_MAX), and as many blocks
    as fill PROBE_BLOCKS_PER_SM on each SM, or fewer when the rows run
    out. ``aligned``: the triples' pointer is a multiple of 16 bytes."""
    if T < 0 or K < 0:
        raise ValueError(f"bad shapes T={T} K={K}")
    stride = max(1, -(-K // SAMPLE_MAX))
    quads = -(-T // PROBE_ROWS)
    blocks = max(1, min(SMS * PROBE_BLOCKS_PER_SM,
                        -(-quads // PROBE_THREADS)))
    return ProbePlan(stride, -(-K // stride), bool(aligned), blocks)


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
        K = keys.shape[0]
        plan = probe_plan(T, K, triples.data_ptr() % 16 == 0)
        sample = (torch.empty(plan.n_samples, dtype=torch.int32,
                              device=triples.device) if plan.stride > 1
                  else None)
        launch("scan_probe", triples.device, triples.data_ptr(), T, s, p, o,
               keys.data_ptr(), K, col, plan.stride, plan.n_samples,
               int(plan.vec), plan.blocks,
               sample.data_ptr() if sample is not None else None,
               mask.data_ptr(), lo.data_ptr(), hi.data_ptr())
    return mask, lo, hi
