"""Computational Resource Allocation — closed-form KKT optimum (paper §4.2).

For a fixed feasible assignment D, minimizing the total compute term
``Σ_k Σ_{n∈N_k} c_n / f_{n,k}`` subject to C3/C4 is convex; stationarity of
the Lagrangian gives the water-filling-like solution

    f*_{n,k} = F_k · sqrt(c_n) / Σ_{m∈N_k} sqrt(c_m)            (Eq. 12)
    O*_calc  = Σ_k ( Σ_{n∈N_k} sqrt(c_n) )² / F_k               (Eq. 13)
"""

from __future__ import annotations

import numpy as np


def allocate_closed_form(De: np.ndarray, c: np.ndarray,
                         F: np.ndarray) -> np.ndarray:
    """Eq. (12). ``De``: [N, K] effective assignment (D*e), c: [N], F: [K].

    Returns f: [N, K] with zeros where De == 0.
    """
    sq = np.sqrt(np.maximum(c, 0.0))[:, None] * (De > 0)
    col = sq.sum(axis=0)                      # Σ_{m∈N_k} sqrt(c_m)
    with np.errstate(invalid="ignore", divide="ignore"):
        f = np.where(col[None, :] > 0, F[None, :] * sq / col[None, :], 0.0)
    return f


def o_total_calc(De: np.ndarray, c: np.ndarray, F: np.ndarray) -> float:
    """Eq. (13): optimal total compute cost for assignment De."""
    sq = np.sqrt(np.maximum(c, 0.0))[:, None] * (De > 0)
    col = sq.sum(axis=0)
    return float((col ** 2 / F).sum())
