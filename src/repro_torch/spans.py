"""Spans of the program's work, recorded only while ``torch.profiler``
records.

A request's root span (:func:`root`, one ``lm_prefill`` call) and the spans
opened inside it (:func:`span`) each record a name, the request's id, the
index of the span that caused it, host start and end on ``time.time_ns``
(the clock of the profiler's events) and device milliseconds.

Device time: on CUDA a timing ``torch.cuda.Event`` on the current stream
at each edge, taken from a pool and read lazily by :func:`records` (after
the caller's synchronize). A root takes an event at its start; every span
takes one at its end; a span's start shares the event of the edge just
before it (its parent's start or the end of its previous sibling), so
siblings that abut share one event, and device work issued between two
edges inside a request is charged to the span that opens next. On the CPU
the host duration stands in for device time.

The switch is the profiler itself: a root checks
``torch.autograd._profiler_enabled()`` once and otherwise returns a shared
no-op, and a span outside a recording root is that no-op. One request is
open at a time. Records are kept in memory, at most :data:`CAP` spans;
the oldest requests are dropped past it.

A leaf module: it imports nothing of the program, so any layer may record.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import torch

CAP = 1 << 20


@dataclass(slots=True)
class Span:
    """One closed span; ``parent`` is the index of the span that caused it
    (None for a root), ``request`` the id its root's request shares."""
    index: int
    name: str
    request: int
    parent: int | None
    start_ns: int = 0
    end_ns: int = 0
    device_ms: float | None = None
    _start: object = field(default=None, repr=False)
    _end: object = field(default=None, repr=False)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_open = None                    # the open request
_closed: deque = deque()        # [spans, read] of each closed request
_kept = 0                       # spans in _closed
_indices, _requests = itertools.count(), itertools.count()
_pool: list = []                # CUDA events free to record


def _event():
    try:
        ev = _pool.pop()
    except IndexError:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Request:
    """The spans of the open root: ``last`` is the event of the latest
    edge, ``stack`` the open spans."""

    def __init__(self, cuda: bool):
        self.id = next(_requests)
        self.cuda = cuda
        self.spans: list = []
        self.stack: list = []
        self.last = None


class _Open:
    """The context of one recording span."""
    __slots__ = ("req", "span")

    def __init__(self, req: _Request, name: str):
        self.req = req
        parent = req.stack[-1].index if req.stack else None
        self.span = Span(next(_indices), name, req.id, parent)

    def __enter__(self):
        req, sp = self.req, self.span
        if req.cuda:
            sp._start = req.last if req.stack else _event()
            req.last = sp._start
        req.spans.append(sp)
        req.stack.append(sp)
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc):
        global _open
        req, sp = self.req, self.span
        sp.end_ns = time.time_ns()
        if req.cuda:
            sp._end = req.last = _event()
        else:
            sp.device_ms = (sp.end_ns - sp.start_ns) / 1e6
        req.stack.pop()
        if not req.stack:
            _open = None
            _keep(req.spans)
        return False


def _keep(spans: list) -> None:
    """A closed request's spans into the records, the oldest requests
    dropped past :data:`CAP`."""
    global _kept
    _closed.append([spans, False])
    _kept += len(spans)
    while _kept > CAP and len(_closed) > 1:
        old, _ = _closed.popleft()
        _kept -= len(old)
        _recycle(old)


def _recycle(spans: list) -> None:
    """A request's events back to the pool (shared edges once)."""
    events = {}
    for sp in spans:
        for ev in (sp._start, sp._end):
            if ev is not None:
                events[id(ev)] = ev
        sp._start = sp._end = None
    _pool.extend(events.values())


def root(name: str, device):
    """A request's root span on ``device`` (``cuda`` times it with events):
    it records, with the spans inside it, only while a profiler session
    records; inside another root it is a child span."""
    global _open
    if _open is None:
        if not torch.autograd._profiler_enabled():
            return NOOP
        _open = _Request(torch.device(device).type == "cuda")
    return _Open(_open, name)


def span(name: str):
    """A span inside the open root, else the no-op."""
    if _open is None:
        return NOOP
    return _Open(_open, name)


def records() -> list:
    """The kept spans of closed requests, oldest first (a request's in the
    order they opened), their device times read."""
    out = []
    for item in _closed:
        spans, read = item
        if not read:
            for sp in spans:
                if sp._end is not None:
                    sp._end.synchronize()
                    sp.device_ms = sp._start.elapsed_time(sp._end)
            _recycle(spans)
            item[1] = True
        out.extend(spans)
    return out
