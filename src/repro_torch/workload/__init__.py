"""Subgraph-sampling workload generation + traffic replay (paper §5).

The benchmark sections of the paper evaluate the cloud-edge stack under
*workloads whose answers are known*: queries are instantiated from the
data so every reported count can be checked, and traffic is shaped
(skewed popularity, bursts, read/write mixes) to exercise the caching and
scheduling layers. This package reproduces that methodology against the
live stores:

- :mod:`~repro_torch.workload.sampler` — :class:`PatternSampler` walks an
  :class:`~repro_torch.rdf.graph.RDFStore` (monolithic or sharded, through the
  protocol surface only) and samples star / path / flower / snowflake
  BGPs whose constants are *witnessed* by actual triples, recording each
  query's **exact** result cardinality at sample time.
- :mod:`~repro_torch.workload.traffic` — :func:`build_schedule` turns sampled
  templates into a deterministic, seeded open-loop schedule: Zipf
  popularity over a hot pool, Poisson or burst arrivals, a cold-template
  reserve, and an optional write mix synthesized against the same store.
- :mod:`~repro_torch.workload.driver` — :func:`replay` pushes a schedule
  through an :class:`~repro_torch.runtime.admission.AdmissionQueue`, reporting
  per-shape latency percentiles, cache-hit trajectories, scheduler
  decisions, and recorded-vs-observed cardinality verification.
"""

from .sampler import PatternSampler, SampledQuery, ShapeConfig
from .traffic import Schedule, ScheduledEvent, TrafficConfig, build_schedule
from .driver import ClassReport, ReplayReport, replay

__all__ = [
    "PatternSampler", "SampledQuery", "ShapeConfig",
    "Schedule", "ScheduledEvent", "TrafficConfig", "build_schedule",
    "ClassReport", "ReplayReport", "replay",
]
