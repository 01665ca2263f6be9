"""R-QAD: the convex relaxation of the query-assignment problem (paper
§4.4), solved on the card.

Paper §4.4 relaxes D in {0,1} to [0,1] (Eq. 16). The solver is a projected
gradient with Nesterov acceleration over

    f(D) = sum_k (sum_n D_nk A_nk)^2 / F_k + sum_nk D_nk b_nk
    A_nk = e_nk sqrt(c_n),   b_nk = e_nk (w_n / r^{n,k} - w_n / r^{n,c})

(the constant cloud term excluded; callers add it), with an exact row
projection onto {d in [0,1]^K : sum_{k: e_nk=1} d_k <= 1} (bisection on the
simplex dual) and a **certified lower bound** from the Frank-Wolfe duality
gap: for convex f and any feasible x, min f >= f(x) + min_{y in C}
grad f(x).(y - x), and the linear minimum over C is closed form (per row
either 0 or the most negative gradient coordinate). B&B pruning therefore
never relies on the iterative solver having converged.

The reference (``repro/core/qad.py``) jit-compiles the solve into one XLA
program and ``vmap``s it over a B&B frontier, in float32. Here the
frontier is a leading dimension: on the card one launch of the
``qad_solve`` CUDA kernel (``csrc/qad_kernels.cu``, one thread block a
child) runs the whole fixed-iteration loop; a CPU tensor takes the plain
torch version (``kernels/ref.py``), with the same float32 arithmetic step
for step. :class:`RqadBounder` keeps A, b, F and e on the device for one
``branch_and_bound`` call, so an expansion uploads only its pinned rows
and reads its bounds back in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.qad_solve import qad_solve, unpack


def build_qad_arrays(c: np.ndarray, w: np.ndarray, e: np.ndarray,
                     r_edge: np.ndarray, r_cloud: np.ndarray,
                     cloud_compute: np.ndarray | None = None,
                     ) -> tuple[np.ndarray, np.ndarray, float]:
    """(A, b, const) for the objective above. Arrays are [N, K].

    ``cloud_compute``: optional [N] per-query cloud compute cost c_n/F_cloud
    (the generalized Eq. 5); it joins the per-row cloud cost both in the
    relative edge gains ``b`` and in the constant term."""
    cloud = w / r_cloud
    if cloud_compute is not None:
        cloud = cloud + np.asarray(cloud_compute, dtype=np.float64)
    A = e * np.sqrt(np.maximum(c, 0.0))[:, None]
    with np.errstate(divide="ignore"):
        edge_tx = np.where(e > 0, w[:, None] / np.maximum(r_edge, 1e-30), 0.0)
    b = e * (edge_tx - cloud[:, None])
    const = float(cloud.sum())
    return A.astype(np.float64), b.astype(np.float64), const


def partial_lb_slack(cloud_cost: np.ndarray,
                     partial_free_cost: np.ndarray) -> float:
    """Certified correction keeping the R-QAD lower bound sound when rows
    carry a partial-evaluation option the relaxation cannot represent.

    The relaxation prices a non-edge row at its cloud cost; a row actually
    taking its partial plan pays at least its congestion-free partial cost
    (edge compute alone-on-the-edge + fixed backhaul/assembly/delivery,
    since (S^2 - (S-s)^2)/F >= s^2/F = c/F). Subtracting
    ``sum_n max(0, cloud_n - partial_free_n)`` therefore lower-bounds every
    completion that swaps any subset of rows from cloud to partial. Rows
    without the option carry ``partial_free_cost = inf`` and contribute 0.
    """
    return float(np.maximum(0.0, cloud_cost - partial_free_cost).sum())


def _f32(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32)
                           if not isinstance(a, torch.Tensor) else a,
                           dtype=torch.float32).to(device).contiguous()


def solve_rqad_batch(A, b, F, e, fixed_mask, fixed_Ds, iters: int = 300,
                     device=None,
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One relaxation per child of a B&B branching step: A, b, e [N, K],
    F [K], fixed_mask [N] (1 pins a row), fixed_Ds [B, N, K] (numpy arrays
    or tensors). Returns float32 tensors (D [B, N, K], f [B], lb [B]) on
    ``device`` (``cuda`` unless the caller names ``"cpu"``); f and lb
    exclude the constant cloud term."""
    dev = resolve_device(device)
    out = qad_solve(_f32(A, dev), _f32(b, dev), _f32(F, dev), _f32(e, dev),
                    _f32(fixed_mask, dev), _f32(fixed_Ds, dev), int(iters))
    return unpack(out, *np.shape(A))


def solve_rqad(A, b, F, e, fixed_mask, fixed_D, iters: int = 300,
               device=None,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize f over free rows; rows with ``fixed_mask`` 1 are pinned to
    ``fixed_D``. Returns (D_relaxed [N, K], objective value, certified lower
    bound) as float32 tensors, both values EXCLUDING the constant cloud
    term."""
    fixed_D = (fixed_D[None] if isinstance(fixed_D, torch.Tensor)
               else np.asarray(fixed_D)[None])
    D, f, lb = solve_rqad_batch(A, b, F, e, fixed_mask, fixed_D, iters,
                                device)
    return D[0], f[0], lb[0]


class RqadBounder:
    """The relaxation of one B&B instance: A, b, F and e go to ``device``
    once; :meth:`solve` bounds one expansion's children with one upload of
    their pinned rows, one ``qad_solve`` launch and one copy back."""

    def __init__(self, A, b, F, e, device=None) -> None:
        self.device = resolve_device(device)
        self.N, self.K = np.shape(A)
        self._arrays = [_f32(x, self.device) for x in (A, b, F, e)]

    def solve(self, fixed_mask: np.ndarray, fixed_Ds: np.ndarray,
              iters: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """fixed_mask [N], fixed_Ds [B, N, K] -> host float32 arrays (D
        [B, N, K], f [B], lb [B])."""
        N, K = self.N, self.K
        B = len(fixed_Ds)
        host = np.empty(N + B * N * K, dtype=np.float32)
        host[:N] = fixed_mask
        host[N:] = np.asarray(fixed_Ds, dtype=np.float32).reshape(-1)
        pinned = torch.from_numpy(host).to(self.device)
        out = qad_solve(*self._arrays, pinned[:N],
                        pinned[N:].view(B, N, K), int(iters))
        D, f, lb = unpack(out.cpu(), N, K)
        return D.numpy(), f.numpy(), lb.numpy()


def round_relaxed(D_relaxed: np.ndarray, e: np.ndarray) -> np.ndarray:
    """Eq. (17) rounding, kept feasible: at most one 1 per row (argmax wins
    when several coordinates tie at >= 0.5, which the simplex constraint
    otherwise forbids only strictly)."""
    D = np.asarray(D_relaxed)
    out = np.zeros_like(D)
    best = D.argmax(axis=1)
    take = D[np.arange(D.shape[0]), best] >= 0.5
    rows = np.arange(D.shape[0])[take]
    out[rows, best[take]] = 1.0
    return out * (e > 0)
