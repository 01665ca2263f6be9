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
— it never falls back.
"""

from __future__ import annotations

import torch

from . import ref
from ._build import check_int32, launch
from .flash_attention import DTYPES


def check_float(name: str, t: torch.Tensor, ndim: int) -> None:
    """Validate a float input or output before its pointer is handed over:
    on the card it must be float32 or bfloat16 and contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
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
    in place."""
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
        launch("segment_sum_sorted", msg.device, msg.data_ptr(),
               dst.data_ptr(), out.data_ptr(),
               None if scratch is None else scratch.data_ptr(),
               DTYPES[msg.dtype], E, D, n_nodes)
    return out
