"""Branch-and-bound for the query-assignment decision (paper Alg. 1).

Search tree: level i decides one EU's placement among {cloud} ∪ {feasible
edges} ∪ {partial} (the partial-evaluation option, when the query carries
one — see :class:`repro_torch.core.cost.PartialOption`). Exactness only
requires that every node's lower bound is certified; the reference names
two bounding modes:

- ``bound="rqad"`` (the paper's convex R-QAD relaxation, solved in JAX by
  the reference package) is not ported yet: it raises
  ``NotImplementedError`` (ROADMAP Queue 1, item 2).
- ``bound="marginal"`` (beyond-paper, default): a congestion-free completion
  bound. With prefix loads S_k = Σ_{fixed n∈N_k} √c_n, a free user's true
  marginal cost on edge k is ≥ (2·S_k·√c_n + c_n)/F_k + w_n/r^{n,k} because
  additional free users only increase S_k; the same telescoping argument
  prices a free user's partial option at
  ≥ Σ_k (2·S_k·P_sq_{n,k} + P_c_{n,k})/F_k + fixed_n. Taking each free
  user's cheapest option therefore lower-bounds every completion. The
  partial option adds one more column — greedy and bounding stay O(N·K).

Upper bounds come from greedy completion of the prefix, evaluated exactly
through the CRA closed form. The search returns certified-optimal solutions
unless ``max_nodes`` (or ``max_seconds``) is hit: then ``optimal=False`` and
the incumbent is returned (anytime mode).

Further beyond-paper optimizations:
- users are branched in descending *impact* order (max feasible saving);
- single-choice users are collapsed instead of branched;
- greedy warm start for the incumbent (paper uses cloud-only; configurable).

Decision encoding: -1 cloud, 0..K-1 edge, K partial. In the returned
``D`` matrix a partial row is all-zero (legacy consumers read it as cloud,
which is also the execution fallback direction); the ``partial`` boolean
mask on :class:`BnBResult` is authoritative.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass

import numpy as np

from .cost import (QueryTasks, SystemParams, assignment_cost,
                   cloud_unit_cost, decisions_cost, partial_fixed_cost)
from .cra import allocate_closed_form


@dataclass
class BnBResult:
    D: np.ndarray                 # [N, K] binary assignment
    f: np.ndarray                 # [N, K] allocated cycles/s
    objective: float              # total cost (Eq. 5 gen., optimal CRA)
    nodes_explored: int
    nodes_pruned: int
    solve_seconds: float
    optimal: bool                 # False if the node cap was hit
    partial: np.ndarray | None = None   # [N] bool: row takes its partial plan


class _Instance:
    """Preprocessed arrays shared across the search."""

    def __init__(self, tasks: QueryTasks, params: SystemParams,
                 order: str) -> None:
        self.N, self.K = tasks.N, params.K
        self.e = (tasks.e * params.assoc).astype(np.float64)
        self.c = tasks.c.astype(np.float64)
        self.w = tasks.w.astype(np.float64)
        self.sq = np.sqrt(np.maximum(self.c, 0.0))
        self.F = params.F.astype(np.float64)
        with np.errstate(divide="ignore"):
            self.tx_edge = np.where(
                self.e > 0, self.w[:, None] / np.maximum(params.r_edge, 1e-30),
                np.inf)
        # cloud path: delivery + (generalized) cloud compute
        self.cloud = cloud_unit_cost(tasks, params).astype(np.float64)
        # partial option arrays (zero / inf when a row has none)
        self.has_partial = np.zeros(self.N, dtype=bool)
        self.P_sq = np.zeros((self.N, self.K))
        self.P_c = np.zeros((self.N, self.K))
        self.part_fixed = np.full(self.N, np.inf)
        if tasks.partial is not None:
            for n, opt in enumerate(tasks.partial):
                if opt is None:
                    continue
                eids = np.asarray(opt.edges, dtype=np.int64)
                cyc = np.maximum(np.asarray(opt.cycles, dtype=np.float64), 0.0)
                self.has_partial[n] = True
                self.P_c[n, eids] = cyc
                self.P_sq[n, eids] = np.sqrt(cyc)
                self.part_fixed[n] = partial_fixed_cost(
                    opt, float(self.w[n]), params, n)
        # alone-on-the-edge saving per user: branching impact
        alone = self.c[:, None] / self.F[None, :] + self.tx_edge
        saving = self.cloud[:, None] - alone
        saving = np.where(self.e > 0, saving, -np.inf)
        impact = saving.max(axis=1)
        part_alone = (self.P_c / self.F[None, :]).sum(axis=1) + self.part_fixed
        impact = np.where(self.has_partial,
                          np.maximum(impact, self.cloud - part_alone), impact)
        if order == "impact":
            self.perm = np.argsort(-impact, kind="stable")
        else:
            self.perm = np.arange(self.N)
        self.inv = np.argsort(self.perm)
        # permuted views
        for name in ("e", "c", "w", "sq", "tx_edge", "cloud",
                     "has_partial", "P_sq", "P_c", "part_fixed"):
            setattr(self, name, getattr(self, name)[self.perm])
        self.choices = [
            [-1] + list(np.flatnonzero(self.e[n] > 0))
            + ([self.K] if self.has_partial[n] else [])
            for n in range(self.N)]

    # ---- exact cost of a complete decision vector -------------------------
    def exact_cost(self, decisions: np.ndarray) -> float:
        S = np.zeros(self.K)
        tx = 0.0
        for n, ch in enumerate(decisions):
            if ch == self.K:
                S += self.P_sq[n]
                tx += self.part_fixed[n]
            elif ch >= 0:
                S[ch] += self.sq[n]
                tx += self.tx_edge[n, ch]
            else:
                tx += self.cloud[n]
        return float((S ** 2 / self.F).sum() + tx)

    # ---- prefix state -------------------------------------------------------
    def prefix_state(self, decisions: list[int]) -> tuple[np.ndarray, float]:
        S = np.zeros(self.K)
        tx = 0.0
        for n, ch in enumerate(decisions):
            if ch == self.K:
                S += self.P_sq[n]
                tx += self.part_fixed[n]
            elif ch >= 0:
                S[ch] += self.sq[n]
                tx += self.tx_edge[n, ch]
            else:
                tx += self.cloud[n]
        return S, tx

    # ---- certified congestion-free lower bound -----------------------------
    def marginal_lb(self, S: np.ndarray, tx: float, depth: int) -> float:
        base = float((S ** 2 / self.F).sum() + tx)
        if depth >= self.N:
            return base
        sq = self.sq[depth:, None]
        c = self.c[depth:, None]
        marg = (2.0 * S[None, :] * sq + c) / self.F[None, :] \
            + self.tx_edge[depth:]
        best = np.minimum(marg.min(axis=1), self.cloud[depth:])
        # partial marginal: P_sq/P_c are zero and part_fixed inf for rows
        # without the option, so pm is inf there and never selected
        pm = ((2.0 * S[None, :] * self.P_sq[depth:] + self.P_c[depth:])
              / self.F[None, :]).sum(axis=1) + self.part_fixed[depth:]
        best = np.minimum(best, pm)
        return base + float(best.sum())

    # ---- greedy completion (upper bound + incumbent) ------------------------
    def greedy_complete(self, decisions: list[int]) -> np.ndarray:
        S, _ = self.prefix_state(decisions)
        out = np.asarray(decisions + [-1] * (self.N - len(decisions)),
                         dtype=np.int64)
        for n in range(len(decisions), self.N):
            best_ch, best_delta = -1, 0.0
            feas = [ch for ch in self.choices[n][1:] if ch != self.K]
            if feas:
                feas = np.asarray(feas)
                delta = ((S[feas] + self.sq[n]) ** 2 - S[feas] ** 2) \
                    / self.F[feas]
                delta += self.tx_edge[n, feas] - self.cloud[n]
                j = int(np.argmin(delta))
                if delta[j] < best_delta:
                    best_ch, best_delta = int(feas[j]), float(delta[j])
            if self.has_partial[n]:
                pd = float((((S + self.P_sq[n]) ** 2 - S ** 2)
                            / self.F).sum()
                           + self.part_fixed[n] - self.cloud[n])
                if pd < best_delta:
                    best_ch, best_delta = self.K, pd
            if best_ch != -1:
                out[n] = best_ch
                if best_ch == self.K:
                    S = S + self.P_sq[n]
                else:
                    S[best_ch] += self.sq[n]
        return out

    def to_D(self, decisions: np.ndarray) -> np.ndarray:
        D = np.zeros((self.N, self.K))
        for n, ch in enumerate(decisions):
            if 0 <= ch < self.K:
                D[n, ch] = 1.0
        return D[self.inv]          # undo the impact permutation

    def to_partial_mask(self, decisions: np.ndarray) -> np.ndarray:
        return (np.asarray(decisions) == self.K)[self.inv]


def branch_and_bound(tasks: QueryTasks, params: SystemParams,
                     strategy: str = "depth_first",
                     bound: str = "marginal",
                     order: str = "impact",
                     warm_start: str = "greedy",
                     max_nodes: int = 200_000,
                     max_seconds: float | None = None,
                     prune_tol: float = 1e-9) -> BnBResult:
    """Alg. 1 (modified): exact minimizer of Eq. (15), three-way plan space.

    ``bound="marginal"`` is the only bound of the port (certified optima);
    ``bound="rqad"`` raises ``NotImplementedError``.
    ``max_nodes`` / ``max_seconds`` turn the solver into an anytime method:
    the greedy-completion incumbent is returned with ``optimal=False`` when
    a budget is hit (at paper scale K=4, N=20 optimality is proven in ms).
    """
    if bound == "rqad":
        raise NotImplementedError(
            'bound="rqad" (the R-QAD relaxation) is not ported yet: ROADMAP '
            'Queue 1, item 2; use bound="marginal"')
    if bound != "marginal":
        raise ValueError(f"unknown bound {bound!r}; options: marginal, rqad")
    t0 = time.perf_counter()
    inst = _Instance(tasks, params, order)
    N, K = inst.N, inst.K

    # incumbent
    if warm_start == "greedy":
        best_dec = inst.greedy_complete([])
    else:
        best_dec = np.full(N, -1, dtype=np.int64)
    best_cost = inst.exact_cost(best_dec)

    counter = itertools.count()
    heap: list[tuple] = []

    def priority(depth: int, lb: float) -> tuple:
        if strategy == "depth_first":
            return (-depth, lb)
        return (lb, -depth)

    S0, tx0 = inst.prefix_state([])
    root_lb = inst.marginal_lb(S0, tx0, 0)
    heapq.heappush(heap, (priority(0, root_lb), next(counter), [], root_lb,
                          S0, tx0))
    explored = pruned = 0
    optimal = True

    while heap:
        if explored >= max_nodes or (max_seconds is not None
                                     and time.perf_counter() - t0
                                     > max_seconds):
            optimal = False
            break
        _, _, decisions, node_lb, S_node, tx_node = heapq.heappop(heap)
        if node_lb > best_cost + prune_tol:
            pruned += 1
            continue
        depth = len(decisions)
        if depth == N:
            cost = inst.exact_cost(np.asarray(decisions))
            if cost < best_cost:
                best_cost, best_dec = cost, np.asarray(decisions)
            continue
        explored += 1
        # expand children, carrying (S, tx) incrementally
        prefixes = [decisions + [ch] for ch in inst.choices[depth]]
        while len(prefixes) == 1 and len(prefixes[0]) < N:
            d2 = len(prefixes[0])
            prefixes = [prefixes[0] + [ch] for ch in inst.choices[d2]]
        child_depth = len(prefixes[0])

        lbs = np.empty(len(prefixes))
        states = []
        for ci, dec in enumerate(prefixes):
            S, tx = S_node.copy(), tx_node
            for nd in range(depth, child_depth):
                ch = dec[nd]
                if ch == K:
                    S += inst.P_sq[nd]
                    tx += inst.part_fixed[nd]
                elif ch >= 0:
                    S[ch] += inst.sq[nd]
                    tx += inst.tx_edge[nd, ch]
                else:
                    tx += inst.cloud[nd]
            states.append((S, tx))
            lbs[ci] = inst.marginal_lb(S, tx, child_depth)

        for ci, dec in enumerate(prefixes):
            if lbs[ci] > best_cost + prune_tol:
                pruned += 1
                continue
            # greedy completion: exact upper bound + candidate incumbent
            full = inst.greedy_complete(dec)
            ub = inst.exact_cost(full)
            if ub < best_cost:
                best_cost, best_dec = ub, full
            if child_depth == N:
                cost = inst.exact_cost(np.asarray(dec))
                if cost < best_cost:
                    best_cost, best_dec = cost, np.asarray(dec)
                continue
            S_c, tx_c = states[ci]
            heapq.heappush(heap, (priority(child_depth, float(lbs[ci])),
                                  next(counter), dec, float(lbs[ci]),
                                  S_c, tx_c))

    D = inst.to_D(best_dec)
    part = inst.to_partial_mask(best_dec)
    e_full = (tasks.e * params.assoc).astype(np.float64)
    f = allocate_closed_form(D * e_full, tasks.c, params.F)
    if part.any():
        obj = decisions_cost(np.asarray(best_dec)[inst.inv], tasks, params)
    else:
        obj = assignment_cost(D, tasks, params)
    return BnBResult(D=D, f=f, objective=float(obj),
                     nodes_explored=explored, nodes_pruned=pruned,
                     solve_seconds=time.perf_counter() - t0, optimal=optimal,
                     partial=part)


def _decisions_to_D(decisions: list[int], N: int, K: int) -> np.ndarray:
    # a partial decision (ch == K) maps to an all-zero row: the relaxation
    # prices it as cloud, which the partial slack correction accounts for
    D = np.zeros((N, K))
    for n, ch in enumerate(decisions):
        if 0 <= ch < K:
            D[n, ch] = 1.0
    return D


def brute_force(tasks: QueryTasks, params: SystemParams) -> BnBResult:
    """Exhaustive minimizer (tests / tiny instances only)."""
    t0 = time.perf_counter()
    N, K = tasks.N, params.K
    e = (tasks.e * params.assoc).astype(np.float64)
    choices = [[-1] + list(np.flatnonzero(e[n] > 0))
               + ([K] if tasks.partial_option(n) is not None else [])
               for n in range(N)]
    best_cost, best_combo = np.inf, tuple([-1] * N)
    n_nodes = 0
    for combo in itertools.product(*choices):
        n_nodes += 1
        cost = decisions_cost(np.asarray(combo, dtype=np.int64),
                              tasks, params)
        if cost < best_cost:
            best_cost, best_combo = cost, combo
    best_D = _decisions_to_D(list(best_combo), N, K)
    part = np.asarray(best_combo, dtype=np.int64) == K
    f = allocate_closed_form(best_D * e, tasks.c, params.F)
    return BnBResult(D=best_D, f=f, objective=float(best_cost),
                     nodes_explored=n_nodes, nodes_pruned=0,
                     solve_seconds=time.perf_counter() - t0, optimal=True,
                     partial=part)
