"""Scheduling baselines (paper §5.1).

- Cloud-Only : every query to the cloud.
- Random     : uniform choice among {cloud} ∪ feasible edges.
- Edge-First : any feasible edge wins (fastest link picked); no resource
               allocation awareness.
- Greedy     : sequentially place each query where its *marginal* cost
               (with CRA-optimal reallocation) is lowest.
"""

from __future__ import annotations

import numpy as np

from .cost import QueryTasks, SystemParams


def cloud_only(tasks: QueryTasks, params: SystemParams) -> np.ndarray:
    return np.zeros((tasks.N, params.K))


def random_assign(tasks: QueryTasks, params: SystemParams,
                  seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    e = tasks.e * params.assoc
    D = np.zeros((tasks.N, params.K))
    for n in range(tasks.N):
        feas = np.flatnonzero(e[n] > 0)
        pick = int(rng.integers(len(feas) + 1))  # 0 == cloud
        if pick > 0:
            D[n, feas[pick - 1]] = 1.0
    return D


def edge_first(tasks: QueryTasks, params: SystemParams) -> np.ndarray:
    e = tasks.e * params.assoc
    D = np.zeros((tasks.N, params.K))
    for n in range(tasks.N):
        feas = np.flatnonzero(e[n] > 0)
        if len(feas):
            D[n, feas[np.argmax(params.r_edge[n, feas])]] = 1.0
    return D


def greedy_assign(tasks: QueryTasks, params: SystemParams) -> np.ndarray:
    """Marginal-cost greedy with incremental Eq. (13) updates, O(N·K).

    Placing user n on edge k changes the objective by
        Δ = ((S_k + √c_n)² − S_k²)/F_k + w_n/r^{n,k} − w_n/r^{n,c}
    where S_k is the current √c load of edge k; Δ_cloud = 0.
    """
    e = tasks.e * params.assoc
    D = np.zeros((tasks.N, params.K))
    S = np.zeros(params.K)
    sq = np.sqrt(np.maximum(tasks.c, 0.0))
    for n in range(tasks.N):
        feas = np.flatnonzero(e[n] > 0)
        if not len(feas):
            continue
        delta = ((S[feas] + sq[n]) ** 2 - S[feas] ** 2) / params.F[feas]
        delta += tasks.w[n] / params.r_edge[n, feas]
        delta -= tasks.w[n] / params.r_cloud[n]
        j = int(np.argmin(delta))
        if delta[j] < 0.0:
            k = feas[j]
            D[n, k] = 1.0
            S[k] += sq[n]
    return D


BASELINES = {
    "cloud_only": cloud_only,
    "random": random_assign,
    "edge_first": edge_first,
    "greedy": greedy_assign,
}
