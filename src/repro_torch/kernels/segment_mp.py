"""Segment sum over destination-sorted edges: the ``segment_sum_sorted``
CUDA kernel.

Wrapper of the kernel in ``csrc/sparse_kernels.cu`` (port of
``repro/kernels/segment_mp.py``), with the Pallas signature: msg [E, D]
float32 or bfloat16, dst [E] int32 sorted ascending, ``n_nodes`` -> [n_nodes,
D] in msg's dtype, summed in float32. Edges whose dst lies outside [0,
n_nodes) are dropped. The sort is the caller's, once per graph
(``repro_torch.models.gnn.sort_by_dst``); the wrapper does not check it on
the device, since that would cost a host sync per call, and unsorted
destinations give wrong sums. A tensor on the CPU takes the plain torch
version in :mod:`.ref`; a tensor on the card launches the kernel or raises
— it never falls back. A meta tensor (the dry run) gets a meta output
(and the bfloat16 route's float32 scratch), and the E * D additions go
to the dry run's tally.

Under autograd (grad mode on and ``msg`` requiring grad) the sum is a
:class:`SegmentSum` Function: the same forward, and a backward that
gathers the output's gradient by ``dst`` (:func:`segment_sum_backward`,
zeros for dropped edges), as XLA differentiates ``jax.ops.segment_sum``
in the reference; that gather is plain torch on both devices. ``out=``
writes in place and so is for serving only: it raises under autograd.

:func:`segment_plan` decides, from the shapes and the pointers' alignment
alone, how the kernel cuts the edges; the launcher takes its fields as
they are and refuses a plan it cannot run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import ref
from ._build import check_int32, launch, tally
from .decode_attention import SMS
from .flash_attention import DTYPES

SEG_THREADS = 256            # threads of a block (the kernel's kSegThreads)
SEG_WARPS = SEG_THREADS // 32
SEG_STAGES = 2               # ring stages (a third was no faster on the H100)
SEG_MAX_STAGES = 4           # (the kernel's kSegMaxStages)
SEG_BLOCKS_PER_SM = 3        # resident blocks an SM at most (the kernel's
                             # kSegMinBlocks, which bounds its registers)
SEG_STAGE_BYTES = 32 * 1024  # messages and dst a stage aims to hold
SM_SMEM = 228 * 1024         # shared memory of an SM ...
BLOCK_RESERVED = 1024        # ... of which each resident block reserves 1 KB
BLOCK_SMEM_MAX = 227 * 1024  # dynamic shared memory a block may take


class SegPlan(NamedTuple):
    per: int       # edges of a block's range: a multiple of 16 bytes' rows
                   # (4 edges for float32, 8 for bfloat16)
    chunk: int     # edges of a ring stage: n_sub * sub
    sub: int       # edges of a thread's sub-span
    n_sub: int     # sub-spans of a chunk
    cols: int      # threads along D: min(D, SEG_THREADS)
    stages: int    # ring stages; 1 on the scalar route
    ring: bool     # chunks by bulk copies (msg and dst on 16 bytes)
    blocks: int    # the persistent grid: ceil(E / per) ranges
    smem: int      # bytes of dynamic shared memory a block takes


def _slot(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def seg_smem_bytes(stages: int, chunk: int, D: int, elem_bytes: int) -> int:
    """A block's dynamic shared memory (the kernel's seg_smem_bytes): the
    stages' messages and dst, the mbarriers, the scan's scratch and the
    carried run sums of every column."""
    return (stages * (_slot(chunk * D * elem_bytes) + _slot(4 * chunk))
            + 8 * SEG_MAX_STAGES + 4 * (2 * SEG_THREADS + 2 * SEG_WARPS)
            + 4 * D)


def seg_ranges(E: int, elem_bytes: int, grid: int) -> tuple[int, int]:
    """(per, blocks): ``E`` edges cut into ranges of ``per`` edges, a
    multiple of 16 bytes' rows (4 float32 or 8 bfloat16 edges), for a grid
    of at most ``grid`` blocks; ``blocks`` = ceil(E / per), at least 1."""
    align = 16 // elem_bytes
    share = max(1, -(-E // grid))                  # ceil(E / grid)
    per = -(-share // align) * align
    return per, max(1, -(-E // per))


def segment_plan(E: int, D: int, elem_bytes: int, aligned: bool) -> SegPlan:
    """How the kernel cuts ``E`` destination-sorted edges of ``D``
    elements of ``elem_bytes`` bytes. ``aligned``: msg's and dst's
    pointers are multiples of 16 bytes.

    Threads along D: ``cols = min(D, 256)`` (wider rows loop over column
    tiles); sub-spans a chunk: ``256 // cols``, a multiple of 8 below D =
    32. A sub-span's edge count ``sub`` is 1 modulo 32 (64 for bfloat16),
    or odd where D is a power of two, so a warp's shared-memory reads fall
    on distinct banks; at D >= 32 it is a multiple of the 16-byte row
    count. Either way a chunk is a multiple of 4 edges (8 for bfloat16) and
    holds about SEG_STAGE_BYTES of messages and dst. Aligned pointers take
    the bulk-copy ring of SEG_STAGES stages, others the scalar route (one
    stage, copied by the threads). The grid: as many blocks as are
    resident, SEG_BLOCKS_PER_SM an SM or fewer where shared memory binds,
    each a range of ``per`` edges. Raises where the ring of the smallest
    chunk does not fit a block (D past about 4,000 float32 elements)."""
    if E < 0 or D <= 0 or elem_bytes not in (2, 4):
        raise ValueError(f"bad shapes E={E} D={D} elem_bytes={elem_bytes}")
    align = 16 // elem_bytes
    cols = min(D, SEG_THREADS)
    per_edge = D * elem_bytes + 4
    if D < 32:
        n_sub = SEG_THREADS // D // 8 * 8
        step = 2 if D & (D - 1) == 0 else 128 // elem_bytes
        fit = SEG_STAGE_BYTES // (n_sub * per_edge)
        sub = max(1 + step, 1 + (fit - 1) // step * step)
    else:
        n_sub = max(1, SEG_THREADS // cols)
        sub = max(align,
                  SEG_STAGE_BYTES // (n_sub * per_edge) // align * align)
    chunk = n_sub * sub
    ring = bool(aligned)
    stages = SEG_STAGES if ring else 1
    smem = seg_smem_bytes(stages, chunk, D, elem_bytes)
    if smem > BLOCK_SMEM_MAX:
        raise ValueError(f"D={D} too wide: {stages} stages of {chunk} edges "
                         f"take {smem} bytes of shared memory")
    grid = SMS * max(1, min(SEG_BLOCKS_PER_SM,
                            SM_SMEM // (smem + BLOCK_RESERVED)))
    per, blocks = seg_ranges(E, elem_bytes, grid)
    return SegPlan(per, chunk, sub, n_sub, cols, stages, ring, blocks, smem)


def check_float(name: str, t: torch.Tensor, ndim: int) -> None:
    """Validate a float input or output before its pointer is handed over:
    on the card it must be float32 or bfloat16 and contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda":
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: the kernels take float32 or bfloat16, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def segment_sum_sorted(msg: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """msg [E, D]; dst [E] int32 sorted ascending -> [n_nodes, D] in msg's
    dtype. ``out`` (contiguous, that shape and dtype) receives the result
    in place; under autograd it raises ``ValueError`` (an in-place write
    would detach the sum from the graph)."""
    if torch.is_grad_enabled() and msg.requires_grad:
        if out is not None:
            raise ValueError("segment_sum_sorted: out= writes in place and "
                             "takes no gradient; call it without out= "
                             "when msg requires grad")
        return SegmentSum.apply(msg, dst, n_nodes)
    return _segment_sum(msg, dst, n_nodes, out)


def segment_sum_backward(grad: torch.Tensor, dst: torch.Tensor,
                         n_nodes: int) -> torch.Tensor:
    """The gradient of the messages: ``grad`` [n_nodes, D] gathered by
    ``dst`` [E] -> [E, D], zero for an edge whose dst lies outside [0,
    n_nodes) (its message was dropped). Row ``n_nodes`` of a zero-padded
    copy of ``grad`` takes those edges, so no host sync is needed."""
    D = grad.shape[1]
    padded = torch.cat((grad, grad.new_zeros((1, D))))
    idx = torch.where((dst >= 0) & (dst < n_nodes), dst, n_nodes)
    return padded.index_select(0, idx)


class SegmentSum(torch.autograd.Function):
    """``segment_sum_sorted`` with a gradient: forward the kernel (the
    plain version on the CPU), backward :func:`segment_sum_backward`."""

    @staticmethod
    def forward(ctx, msg, dst, n_nodes):
        ctx.save_for_backward(dst)
        ctx.n_nodes = int(n_nodes)
        return _segment_sum(msg, dst, n_nodes, None)

    @staticmethod
    def backward(ctx, grad):
        dst, = ctx.saved_tensors
        return segment_sum_backward(grad, dst, ctx.n_nodes), None, None


def _segment_sum(msg: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 out: torch.Tensor | None) -> torch.Tensor:
    """The dispatch: the kernel on the card, the plain version on the
    CPU."""
    check_float("msg", msg, 2)
    check_int32("dst", dst, 1, device=msg.device)
    n_nodes = int(n_nodes)
    E, D = msg.shape
    if dst.shape[0] != E:
        raise ValueError(f"dst has {dst.shape[0]} edges, msg {E}")
    if not 0 <= n_nodes < 2 ** 31:
        raise ValueError(f"n_nodes {n_nodes} out of range")
    if out is None:
        out = torch.empty((n_nodes, D), dtype=msg.dtype, device=msg.device)
    else:
        check_float("out", out, 2)
        if (out.shape != (n_nodes, D) or out.dtype != msg.dtype
                or out.device != msg.device):
            raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                             f"{out.device} must be {(n_nodes, D)} "
                             f"{msg.dtype} on {msg.device}")
    if msg.device.type == "cpu":
        return out.copy_(ref.segment_sum_sorted_reference(msg, dst, n_nodes))
    if out.numel():
        scratch = None
        if msg.dtype != torch.float32:
            scratch = torch.empty((n_nodes, D), dtype=torch.float32,
                                  device=msg.device)
        if msg.device.type == "meta":
            tally("segment_sum_sorted", E * D)
            return out
        plan = segment_plan(E, D, msg.element_size(),
                            (msg.data_ptr() | dst.data_ptr()) % 16 == 0)
        launch("segment_sum_sorted", msg.device, msg.data_ptr(),
               dst.data_ptr(), out.data_ptr(),
               None if scratch is None else scratch.data_ptr(),
               DTYPES[msg.dtype], E, D, n_nodes, plan.per, plan.chunk,
               plan.sub, plan.n_sub, plan.cols, plan.stages, int(plan.ring),
               plan.blocks)
    return out
