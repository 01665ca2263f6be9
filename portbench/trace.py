"""The traced run: the window under ``torch.profiler`` (the device's
activity alone, so the host pays no cost per operator), read from the raw
events as ``chip_smoke.device_profile`` reads them.

Busy time is the union of the intervals in which a kernel, copy or set ran
on the card, clipped to the window; idle is the rest of the window. Each
idle stretch is put down to the host span (:class:`serve.Spans`) that
covers its middle, ``outside`` where none does.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)       # name: [seconds, count]
    idle_by_span: dict = field(default_factory=dict)   # span: seconds

    def op_seconds(self, part: str) -> tuple[float, int]:
        """Seconds and launches of the device operations whose names hold
        ``part``."""
        hits = [v for k, v in self.ops.items() if part in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)


def device_intervals(prof) -> list:
    """(start_ns, end_ns, name) of every device event of a finished
    profiler session."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if (not str(e.device_type()).endswith("CUDA")
                or e.is_user_annotation()):
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns(), e.name()))
    return out


def union(intervals: list, lo: int, hi: int) -> list:
    """The disjoint [start, end) pieces covered by ``intervals`` within
    [lo, hi), in order."""
    pieces: list = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if pieces and s <= pieces[-1][1]:
            pieces[-1][1] = max(pieces[-1][1], e)
        else:
            pieces.append([s, e])
    return pieces


def label(spans: list, starts: list, t: int) -> str:
    """The host span covering time ``t``; ``spans`` do not overlap and are
    sorted by start, ``starts`` their starts."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < spans[i][2]:
        return spans[i][0]
    return "outside"


def read(intervals: list, spans: list, lo: int, hi: int) -> Trace:
    """A :class:`Trace` of device ``intervals`` and host ``spans`` over the
    window [lo, hi) (nanoseconds on one clock)."""
    busy = union(intervals, lo, hi)
    ops: dict = {}
    for s, e, name in intervals:
        if lo <= s < hi:
            item = ops.setdefault(name, [0.0, 0])
            item[0] += (e - s) / 1e9
            item[1] += 1
    idle: dict = {}
    edges = [lo] + [x for piece in busy for x in piece] + [hi]
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            name = label(spans, starts, (a + b) // 2)
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    return Trace(window_s=(hi - lo) / 1e9,
                 busy_s=sum(e - s for s, e in busy) / 1e9, ops=ops,
                 idle_by_span=idle)


def breakdown(tr: Trace) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the idle time by host span, in seconds."""
    ops = sorted(((v[0], k) for k, v in tr.ops.items()), reverse=True)
    idle = sorted(((v, k) for k, v in tr.idle_by_span.items()), reverse=True)
    return {"device_ops": [[k[:120], s] for s, k in ops[:10]],
            "idle_gaps": [[k, s] for s, k in idle[:10]]}
