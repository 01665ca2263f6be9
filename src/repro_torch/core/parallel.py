"""Shared dispatch helper for overlapped batch execution.

Used by :meth:`repro_torch.edge.system.EdgeCloudSystem.run_round_batched`
(thread mode) and :meth:`repro_torch.runtime.serving.OffloadServingPool.admit`
so the worker-count heuristic lives in one place.
"""

from __future__ import annotations

from typing import Callable, Iterable


def thread_map(fn: Callable, items: Iterable,
               max_workers: int | None = None) -> list:
    """``[fn(it) for it in items]`` through a thread pool.

    Single-item (or empty) inputs run inline. Worker count defaults to
    ``min(len(items), cpu_count + 1)`` — oversubscribing cores serializes
    on the GIL instead of overlapping, while one extra worker packs uneven
    loads best.
    """
    items = list(items)
    if len(items) <= 1:
        return [fn(it) for it in items]
    import os
    from concurrent.futures import ThreadPoolExecutor

    workers = max_workers or min(len(items), (os.cpu_count() or 2) + 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))
