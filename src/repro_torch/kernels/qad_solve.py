"""R-QAD solve of a B&B frontier: the ``qad_solve`` CUDA kernel.

Wrapper of the kernel in ``csrc/qad_kernels.cu``. It replaces no
``pl.pallas_call``: the reference solves the relaxation as one jitted XLA
program (``repro/core/qad.py:solve_rqad``, a ``fori_loop`` of Nesterov
steps, each projecting every row with a 40-step bisection), ``vmap``ped
over the frontier (``solve_rqad_batch``). Written as eager torch that loop
is about 345 small ops a step, some 100k launches a solve, so on the card
it is one kernel: one thread block a child runs every iteration, one
thread a row.

:func:`qad_plan` picks the route from the shapes alone: the register
route (K <= 16, N <= 1,024: each row in its thread's registers, K padded
to 4, 8 or 16; one warp a child up to 32 rows) or the generic route (the
instance in shared memory; an instance whose arrays do not fit in a
block's shared memory raises ``ValueError``). A tensor on the CPU takes
the plain torch version in :mod:`.ref`; a tensor on the card launches the
kernel or raises — it never falls back. Each launch counts as
``qad_solve`` and as ``qad_solve/<route>``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import ref
from ._build import launch

QAD_MAX_THREADS = 1024       # threads of a block at most (one row each)
QAD_ARRAYS = 5               # the generic route's [N, K] arrays in shared
                             # memory: A, b, e, x, x_prev
BLOCK_SMEM_MAX = 227 * 1024  # dynamic shared memory a block may take
QAD_KMAX = (4, 8, 16)        # the register route's K, padded up to these
ROUTES = ("generic", "register")   # codes 0 and 1 of the C interface


class QadPlan(NamedTuple):
    route: str               # "register" or "generic"
    kmax: int                # the register route's padded K; 0 on generic
    threads: int             # a multiple of 32; thread t owns rows t, t+T..
    smem_bytes: int          # dynamic shared memory (0 on the register
                             # route, whose few arrays are static)


def generic_plan(N: int, K: int) -> QadPlan:
    """The generic route for an [N, K] instance: one thread a row up to
    1,024 rows (then rows round-robin), five [N, K] float32 arrays in
    shared memory, the pin mask, F, the column sums and one partial a warp
    and column."""
    threads = min(QAD_MAX_THREADS, -(-N // 32) * 32)
    warps = threads // 32
    floats = QAD_ARRAYS * N * K + N + 3 * K + warps * K
    smem = 4 * floats
    if smem > BLOCK_SMEM_MAX:
        raise ValueError(
            f"qad_solve: an instance of N={N} rows and K={K} edges needs "
            f"{smem} bytes of shared memory, above a block's "
            f"{BLOCK_SMEM_MAX}; the kernel keeps the instance in shared "
            "memory (five [N, K] float32 arrays)")
    return QadPlan("generic", 0, threads, smem)


def qad_plan(N: int, K: int) -> QadPlan:
    """The route and block of the kernel for an [N, K] instance, from the
    shapes alone: the register route for K <= 16 and N <= 1,024 (one
    thread a row, one warp a child up to 32 rows), else the generic
    route."""
    if N < 1 or K < 1:
        raise ValueError(f"qad_solve needs N, K >= 1, got N={N}, K={K}")
    if K <= QAD_KMAX[-1] and N <= QAD_MAX_THREADS:
        kmax = next(k for k in QAD_KMAX if K <= k)
        return QadPlan("register", kmax, -(-N // 32) * 32, 0)
    return generic_plan(N, K)


def unpack(out: torch.Tensor, N: int, K: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Views (D [B, N, K], f [B], lb [B]) of a packed [B, N*K + 2] result."""
    B = out.shape[0]
    return (out[:, :N * K].view(B, N, K), out[:, N * K],
            out[:, N * K + 1])


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def qad_solve(A: torch.Tensor, b: torch.Tensor, F: torch.Tensor,
              e: torch.Tensor, fixed_mask: torch.Tensor,
              fixed_Ds: torch.Tensor, iters: int) -> torch.Tensor:
    """A, b, e [N, K], F [K], fixed_mask [N] (0 or 1), fixed_Ds [B, N, K],
    float32 on one device -> [B, N*K + 2] float32: each child's relaxed D,
    its objective and its certified lower bound (see
    :func:`.ref.qad_solve_reference`; :func:`unpack` splits it)."""
    if not isinstance(A, torch.Tensor) or A.dim() != 2:
        raise ValueError("A must be a [N, K] tensor")
    N, K = A.shape
    dev = A.device
    if not isinstance(fixed_Ds, torch.Tensor) or fixed_Ds.dim() != 3:
        raise ValueError("fixed_Ds must be a [B, N, K] tensor")
    B = fixed_Ds.shape[0]
    for name, t, shape in (("A", A, (N, K)), ("b", b, (N, K)),
                           ("F", F, (K,)), ("e", e, (N, K)),
                           ("fixed_mask", fixed_mask, (N,)),
                           ("fixed_Ds", fixed_Ds, (B, N, K))):
        _check(name, t, shape, dev)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if dev.type == "cpu":
        return ref.qad_solve_reference(A, b, F, e, fixed_mask, fixed_Ds,
                                       int(iters))
    plan = qad_plan(N, K)
    out = torch.empty((B, N * K + 2), dtype=torch.float32, device=dev)
    if B:
        launch("qad_solve", dev, A.data_ptr(), b.data_ptr(), F.data_ptr(),
               e.data_ptr(), fixed_mask.data_ptr(), fixed_Ds.data_ptr(),
               out.data_ptr(), B, N, K, int(iters), ROUTES.index(plan.route),
               plan.kmax, plan.threads, plan.smem_bytes, route=plan.route)
    return out
