"""The program's own spans (``repro_torch.spans``), which it
records while the traced run's profiler records: device milliseconds a
request of some of the parts of ``lm_prefill``.

A request is a ``prefill`` root whose host start lies in the window
[``start_ns``, ``end_ns``), on ``time.time_ns``'s clock (the window's and
the spans' both), so records of earlier windows in the process fall out.
A program without spans, an untraced run and a window that is not prefill
read None.
"""

from __future__ import annotations


def per_request_ms(run, names: tuple) -> float | None:
    """The device milliseconds of the spans named ``names`` in the
    window's requests, over the number of requests."""
    w = run.window
    if run.trace is None or w.kind != "prefill":
        return None
    try:
        from repro_torch.spans import records
    except ImportError:         # a program that records no spans
        return None
    recs = records()
    requests = {r.request for r in recs
                if r.parent is None and r.name == "prefill"
                and w.start_ns <= r.start_ns < w.end_ns}
    if not requests:
        return None
    return sum(r.device_ms for r in recs
               if r.request in requests and r.name in names) / len(requests)
