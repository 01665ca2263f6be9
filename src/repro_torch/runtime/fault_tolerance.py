"""Fault tolerance: stragglers, retries, elastic re-meshing (port of
``repro/runtime/fault_tolerance.py``, which uses no JAX).

1. **Transient step failure**: ``with_retries`` re-executes the step
   function.
2. **Stragglers**: ``StragglerMonitor`` keeps an EWMA of step time; a step
   exceeding ``factor``x the EWMA (or an absolute deadline) is flagged,
   and a flagged step does not enter the EWMA.
3. **Node loss -> elastic re-mesh**: ``plan_mesh`` picks the largest
   (data, model) grid for the surviving device count with the model axis
   preserved; the driver then restores the latest checkpoint (host arrays,
   so any layout can read it) and resumes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def with_retries(fn, n_retries: int = 2, backoff_s: float = 0.0,
                 on_error=None):
    """Run fn(); on exception retry up to n_retries times."""
    def wrapped(*a, **kw):
        err = None
        for attempt in range(n_retries + 1):
            try:
                return fn(*a, **kw)
            except Exception as e:  # noqa: BLE001 — deliberate catch-all
                err = e
                if on_error is not None:
                    on_error(attempt, e)
                if backoff_s:
                    time.sleep(backoff_s * (2 ** attempt))
        raise err
    return wrapped


@dataclass
class StragglerMonitor:
    """EWMA-based straggler detection over step durations."""

    factor: float = 3.0
    deadline_s: float | None = None
    alpha: float = 0.2
    ewma: float | None = None
    flagged_steps: list[int] = field(default_factory=list)

    def observe(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if self.deadline_s is not None and duration_s > self.deadline_s:
            is_straggler = True
        if self.ewma is not None and duration_s > self.factor * self.ewma:
            is_straggler = True
        # stragglers don't poison the EWMA
        if not is_straggler:
            self.ewma = (duration_s if self.ewma is None
                         else self.alpha * duration_s
                         + (1 - self.alpha) * self.ewma)
        if is_straggler:
            self.flagged_steps.append(step)
        return is_straggler


def plan_mesh(n_devices: int, model_axis: int,
              pod_axis: int = 1) -> tuple[int, ...]:
    """Largest (pod, data, model) grid for the surviving device count.

    Keeps the model (TP) axis intact and shrinks data parallelism. Drops
    stray devices that don't fill a full data row (they become hot
    spares).
    """
    per_pod = n_devices // pod_axis
    data = per_pod // model_axis
    if data < 1:
        raise ValueError(
            f"{n_devices} devices cannot sustain model axis {model_axis}")
    if pod_axis > 1:
        return (pod_axis, data, model_axis)
    return (data, model_axis)


def simulate_failure(devices: list, n_lost: int) -> list:
    """Drop the last n_lost devices (deterministic for tests)."""
    if n_lost >= len(devices):
        raise ValueError("cannot lose every device")
    return devices[: len(devices) - n_lost]
