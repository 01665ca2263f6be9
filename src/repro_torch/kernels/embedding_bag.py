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
"""

from __future__ import annotations

import torch

from . import ref
from ._build import check_int32, launch
from .flash_attention import DTYPES
from .segment_mp import check_float

COMBINERS = ("mean", "sum")


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
        launch("embedding_bag", table.device, table.data_ptr(),
               ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
               DTYPES[table.dtype], B * F, NNZ, D,
               int(combiner == "mean"))
    return out
