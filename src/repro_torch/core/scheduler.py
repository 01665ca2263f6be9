"""Unified scheduler facade: one entry point for all assignment policies.

``schedule(tasks, params, policy=...)`` returns (D, f, objective, info).
Policies: "bnb" (the paper's method), plus the four §5.1 baselines.

This facade is also what the model-serving runtime uses to place inference
requests across replica pools (see repro_torch.runtime.serving) — the paper's
scheduler as a first-class framework feature.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .baselines import BASELINES
from .bnb import BnBResult, branch_and_bound
from .cost import QueryTasks, SystemParams, assignment_cost
from .cra import allocate_closed_form


@dataclass
class ScheduleResult:
    D: np.ndarray
    f: np.ndarray
    objective: float
    policy: str
    info: dict[str, Any]
    partial: np.ndarray | None = None   # [N] bool: row takes its partial plan


def schedule(tasks: QueryTasks, params: SystemParams, policy: str = "bnb",
             **kw) -> ScheduleResult:
    if policy == "bnb":
        r: BnBResult = branch_and_bound(tasks, params, **kw)
        return ScheduleResult(D=r.D, f=r.f, objective=r.objective,
                              policy=policy,
                              info={"nodes_explored": r.nodes_explored,
                                    "nodes_pruned": r.nodes_pruned,
                                    "solve_seconds": r.solve_seconds,
                                    "optimal": r.optimal},
                              partial=r.partial)
    if policy in BASELINES:
        D = BASELINES[policy](tasks, params, **kw)
        De = D * tasks.e * params.assoc
        f = allocate_closed_form(De, tasks.c, params.F)
        return ScheduleResult(D=D, f=f,
                              objective=assignment_cost(D, tasks, params),
                              policy=policy, info={})
    raise ValueError(f"unknown policy {policy!r}; options: bnb, "
                     + ", ".join(BASELINES))
