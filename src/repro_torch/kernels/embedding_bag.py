"""Masked bag reduction of table rows: the ``embedding_bag`` CUDA kernel.

Wrapper of the kernel in ``csrc/sparse_kernels.cu`` (port of
``repro/kernels/embedding_bag.py``'s ``embedding_bag_pallas``), with its
signature: table [V, D] float32 or bfloat16, ids int32 [B, F, NNZ], mask
[B, F, NNZ] (cast to float32, a weight per entry) -> [B, F, D] in the
table's dtype: ``sum_z table[ids[z]] * mask[z]``, or for ``mean`` that sum
over ``max(sum_z mask[z], 1)``. Every addressed row is read, masked or not.
Ids are not range-checked on the device (a host sync per call would
serialise serving): an id outside [0, V) reads outside the table. A tensor
on the CPU takes the plain torch version in :mod:`.ref`; a tensor on the
card launches the kernel or raises — it never falls back.

:func:`bag_plan` decides, from the shapes and the table's alignment
alone, how the kernel cuts the work; the launcher takes its fields as
they are.

Training (:class:`EmbeddingBag`): the table's gradient is the
``embedding_bag_bwd`` kernel (``csrc/sparse_kernels.cu``, no Pallas
counterpart: the reference differentiates its plain gather in XLA), a
dense [V, D] tensor: zeroed, then each entry of each bag adds ``g * w``
into its row by atomics (``w`` the entry's mask, over the bag's count
for ``mean``). Ids and mask take no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import ref
from ._build import check_int32, launch
from .decode_attention import SMS
from .flash_attention import DTYPES
from .segment_mp import check_float

COMBINERS = ("mean", "sum")
BAG_THREADS = 256            # threads of a block (the kernel's kBagThreads)
BAG_BLOCKS_PER_SM = 4        # blocks of the persistent grid on each SM,
                             # all resident (the kernel's kBagMinBlocks)
BAG_STAGES = 3               # ring stages (the kernel's kBagStages)
CHUNK_BYTES = 2048           # ids a chunk aims to hold, in bytes
RING_SMEM = 48 * 1024        # dynamic shared memory the ring may take


class BagPlan(NamedTuple):
    vec: int       # table elements a lane loads at once: 16 bytes, or 1
    lanes: int     # lanes that read one row (a power of two, at most 32)
    groups: int    # bags a block works on at once: BAG_THREADS // lanes
    chunk: int     # consecutive bags a block takes per ring stage
    n_chunks: int
    blocks: int    # the persistent grid
    ring: bool     # ids and mask staged in shared memory by bulk copies
    smem: int      # bytes of dynamic shared memory (0 without the ring)


def ring_slot_bytes(chunk: int, nnz: int) -> int:
    """Bytes of one ring slot: a chunk's ids (or mask) plus 16, so the
    slot can start the copy at the source's offset within 16 bytes."""
    return (chunk * nnz * 4 + 16 + 15) // 16 * 16


def bag_plan(n_bags: int, nnz: int, D: int, elem_bytes: int,
             aligned: bool) -> BagPlan:
    """How the kernel cuts ``n_bags`` bags of ``nnz`` ids over rows of
    ``D`` elements of ``elem_bytes`` bytes. ``aligned``: the table's
    pointer is a multiple of 16 bytes.

    A lane loads 16 bytes of a row at once where every row starts on 16
    bytes (D a multiple of the 16-byte width, table aligned), else one
    element. Lanes per row: the power of two that covers D in such loads,
    at most 32 (wider rows loop over columns). A chunk holds whole
    multiples of the block's groups and about CHUNK_BYTES of ids, a
    multiple of 4 bags, so a chunk's ids and mask start on 16 bytes. The
    ring takes BAG_STAGES slots of each and must fit RING_SMEM; where one
    bag's NNZ is too long for that, or NNZ is 0, ids and mask are read
    from device memory directly."""
    if n_bags < 0 or nnz < 0 or D <= 0 or elem_bytes not in (2, 4):
        raise ValueError(f"bad shapes n_bags={n_bags} nnz={nnz} D={D} "
                         f"elem_bytes={elem_bytes}")
    per16 = 16 // elem_bytes
    vec = per16 if aligned and D % per16 == 0 else 1
    lanes = min(32, 1 << (-(-D // vec) - 1).bit_length())
    groups = BAG_THREADS // lanes
    per_bag = max(1, nnz) * 4
    chunk = groups * max(1, CHUNK_BYTES // (groups * per_bag))
    room = RING_SMEM // (2 * BAG_STAGES) - 16
    if chunk * per_bag > room:                 # long bags: fewer a chunk
        chunk = max(4, room // per_bag // 4 * 4)
    ring = nnz > 0 and 2 * BAG_STAGES * ring_slot_bytes(chunk, nnz) \
        + 8 * BAG_STAGES <= RING_SMEM
    if not ring:
        chunk = groups
    n_chunks = -(-n_bags // chunk)
    blocks = max(1, min(n_chunks, SMS * BAG_BLOCKS_PER_SM))
    smem = (2 * BAG_STAGES * ring_slot_bytes(chunk, nnz) + 8 * BAG_STAGES
            if ring else 0)
    return BagPlan(vec, lanes, groups, chunk, n_chunks, blocks, ring, smem)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  combiner: str = "mean") -> torch.Tensor:
    """table [V, D]; ids int32 / mask [B, F, NNZ] -> bags [B, F, D]."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got "
                         f"{combiner!r}")
    check_float("table", table, 2)
    check_int32("ids", ids, 3, device=table.device)
    if not isinstance(mask, torch.Tensor) or mask.shape != ids.shape:
        raise ValueError(f"mask must be a tensor of ids' shape "
                         f"{tuple(ids.shape)}")
    if mask.device != table.device:
        raise ValueError(f"mask is on {mask.device}, expected {table.device}")
    if table.device.type == "cpu":
        return ref.embedding_bag_reference(table, ids, mask, combiner)
    B, F, NNZ = ids.shape
    D = table.shape[1]
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty((B, F, D), dtype=table.dtype, device=table.device)
    if out.numel():
        plan = bag_plan(B * F, NNZ, D, table.element_size(),
                        table.data_ptr() % 16 == 0)
        launch("embedding_bag", table.device, table.data_ptr(),
               ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
               DTYPES[table.dtype], B * F, NNZ, D,
               int(combiner == "mean"), plan.vec, plan.lanes, plan.chunk,
               plan.blocks, int(plan.ring))
    return out


def embedding_bag_backward(g: torch.Tensor, ids: torch.Tensor,
                           mask: torch.Tensor, n_rows: int,
                           combiner: str = "mean") -> torch.Tensor:
    """The table's gradient [n_rows, D] of :func:`embedding_bag` for the
    output gradient g [B, F, D] (the table's dtype): ids int32 / mask
    [B, F, NNZ] as the forward took them. The CPU takes the plain version
    (``zeros`` + ``index_add_``); the card launches ``embedding_bag_bwd``
    or raises. Ids are not range-checked on the card."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got "
                         f"{combiner!r}")
    check_float("g", g, 3)
    check_int32("ids", ids, 3, device=g.device)
    if not isinstance(mask, torch.Tensor) or mask.shape != ids.shape:
        raise ValueError(f"mask must be a tensor of ids' shape "
                         f"{tuple(ids.shape)}")
    if g.shape[:2] != ids.shape[:2] or mask.device != g.device:
        raise ValueError(f"g {tuple(g.shape)} and ids {tuple(ids.shape)} "
                         f"must share [B, F] and a device")
    if g.device.type == "cpu":
        return ref.embedding_bag_backward_reference(g, ids, mask, n_rows,
                                                    combiner)
    B, F, NNZ = ids.shape
    D = g.shape[2]
    mask = mask.to(torch.float32).contiguous()
    grad = torch.empty((n_rows, D), dtype=g.dtype, device=g.device)
    scratch = (torch.empty((n_rows, D), dtype=torch.float32, device=g.device)
               if g.dtype == torch.bfloat16 else None)
    launch("embedding_bag_bwd", g.device, g.data_ptr(), ids.data_ptr(),
           mask.data_ptr(), grad.data_ptr(),
           None if scratch is None else scratch.data_ptr(), DTYPES[g.dtype],
           B * F, NNZ, D, n_rows, int(combiner == "mean"))
    return grad


class EmbeddingBag(torch.autograd.Function):
    """:func:`embedding_bag` with the table's gradient
    (:func:`embedding_bag_backward`); ids and mask take none."""

    @staticmethod
    def forward(ctx, table, ids, mask, combiner: str = "mean"):
        ctx.save_for_backward(ids, mask)
        ctx.n_rows, ctx.combiner = table.shape[0], combiner
        return embedding_bag(table, ids, mask, combiner)

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        grad = embedding_bag_backward(g.contiguous(), ids, mask, ctx.n_rows,
                                      ctx.combiner)
        return grad, None, None, None
