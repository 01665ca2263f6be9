"""Sorted-probe join: the device side of the matcher's presorted join.

Wrappers of the ``probe_sorted_many`` and ``scan_probe`` CUDA kernels in
``csrc/rdf_kernels.cu`` (ports of ``repro/kernels/join_probe.py``). For
every probe value ``v`` against ascending keys, ``lo = #(keys < v)`` and
``hi = #(keys <= v)``, bit-identical to ``np.searchsorted`` left/right.
A tensor on the CPU takes the plain torch version in :mod:`.ref`; a tensor
on the card launches the kernel or raises — it never falls back.

Both kernels search in two levels: every ``stride``-th key sits in
shared memory (at most SAMPLE_MAX of them, gathered once per call into a
scratch buffer), and a search there leaves a window of ``stride - 1``
keys in device memory. :func:`probe_plan` picks the stride and the grid
from the shapes; the launchers take them as they are.
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
SAMPLE_MIN = 1024            # a sample the plan never shrinks below (4 KB)
SAMPLE_PER_PROBE = 32        # sample keys a block may copy for each probe
                             # it searches: one coalesced load wavefront,
                             # where each halving of the window saves one
                             # uncoalesced load a probe
PROBE_SPAN = 12              # window keys the 16-byte loads finish
PROBE_THREADS = 1024         # threads of a block (the kernel's
                             # kProbeThreads)
PROBE_ROWS = 4               # consecutive rows a thread takes
PROBE_BLOCKS_PER_SM = 1      # blocks of the persistent grid on each SM
PROBE_MIN_QUADS = 32         # quads of probes a block takes at least: a
                             # search's key loads are one L1 wavefront a
                             # lane, so spread over SMs even a small call


class ProbePlan(NamedTuple):
    stride: int     # keys[0], keys[stride], ... form the sample; 0: none
    n_samples: int  # ceil(K / stride), at most sample_cap; 0 for none
    vec: bool       # rows or probes read as 16-byte loads (16-byte aligned)
    blocks: int     # the persistent grid


def sample_cap(n: int, blocks: int) -> int:
    """The most keys a plan puts in the sample for ``n`` probes (or rows)
    over ``blocks`` blocks: each block copies the whole sample, so it
    takes at most SAMPLE_PER_PROBE keys for each probe the block searches,
    within [SAMPLE_MIN, SAMPLE_MAX]. A few thousand probes then copy a few
    KB a block, not 128 KB; the serving shapes (over 1,000 probes a
    block) keep SAMPLE_MAX."""
    return min(SAMPLE_MAX,
               max(SAMPLE_MIN, SAMPLE_PER_PROBE * -(-n // max(1, blocks))))


def probe_plan(n: int, K: int, aligned: bool) -> ProbePlan:
    """The sample and grid of the two-level search of n probes (the rows
    of ``scan_probe``, or the probes of ``probe_sorted_many``) against K
    keys: as many blocks as fill PROBE_BLOCKS_PER_SM on each SM, or fewer
    when the probes run out (PROBE_MIN_QUADS quads of PROBE_ROWS a block
    at least), and the smallest stride that keeps the sample within
    :func:`sample_cap` keys (stride 1, the whole array, when K fits). A
    call of fewer than SAMPLE_MIN / SAMPLE_PER_PROBE probes takes no
    sample (stride 0): its searches start from every key, with no gather
    launched and nothing copied. ``aligned``: the triples' or probes'
    pointer is a multiple of 16 bytes."""
    if n < 0 or K < 0:
        raise ValueError(f"bad shapes n={n} K={K}")
    quads = -(-n // PROBE_ROWS)
    blocks = max(1, min(SMS * PROBE_BLOCKS_PER_SM,
                        -(-quads // PROBE_MIN_QUADS)))
    if K > SAMPLE_MIN and n * SAMPLE_PER_PROBE < SAMPLE_MIN:
        return ProbePlan(0, 0, bool(aligned), blocks)
    stride = max(1, -(-K // sample_cap(n, blocks)))
    return ProbePlan(stride, -(-K // stride), bool(aligned), blocks)


def _sample_buffer(plan: ProbePlan, device: torch.device):
    """Scratch for the gathered sample (none at stride 0, no sample, or 1,
    where the keys are the sample)."""
    return (torch.empty(plan.n_samples, dtype=torch.int32, device=device)
            if plan.stride > 1 else None)


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
        K = keys.shape[0]
        plan = probe_plan(n, K, probes.data_ptr() % 16 == 0)
        sample = _sample_buffer(plan, keys.device)
        launch("probe_sorted_many", keys.device, keys.data_ptr(), K,
               probes.data_ptr(), n, plan.stride, plan.n_samples,
               int(plan.vec), plan.blocks,
               sample.data_ptr() if sample is not None else None,
               lo.data_ptr(), hi.data_ptr())
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
        sample = _sample_buffer(plan, triples.device)
        launch("scan_probe", triples.device, triples.data_ptr(), T, s, p, o,
               keys.data_ptr(), K, col, plan.stride, plan.n_samples,
               int(plan.vec), plan.blocks,
               sample.data_ptr() if sample is not None else None,
               mask.data_ptr(), lo.data_ptr(), hi.data_ptr())
    return mask, lo, hi
