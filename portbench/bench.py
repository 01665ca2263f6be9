"""One run of one cell: set-up, the measured window (traced or not), the
check, and the metrics read from what the run recorded."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import torch

from . import check, inputs, serve, spec, trace
from .reference import Model


@dataclass
class Run:
    """What a metric's reader (``metrics/<name>.py``) reads."""
    model: Model
    traffic: dict
    window: serve.Window
    setup_s: float
    device_kind: str
    trace: trace.Trace | None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, started: float, program=None) -> tuple[dict, dict]:
    """(the result line's object, the compared numbers). ``started``: the
    ``perf_counter`` reading at the process's start; ``program``: the
    entry points, for the tests' planted faults."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    m = Model.from_config(cell.config)
    cfg = serve.lm_config(m, cell.config)
    marks = [("start", time.perf_counter())]
    params = inputs.weights(m, seed, dev)
    sync(dev)
    marks.append(("weights", time.perf_counter()))
    loop = serve.Loop(cfg, m, cell.traffic, params, seed, dev, program)
    del params
    sync(dev)
    marks.append(("state", time.perf_counter()))
    loop.warm()
    sync(dev)
    marks.append(("warm", time.perf_counter()))
    print("setup " + " ".join(f"{b[0]} {b[1] - a[1]:.3f}s" for a, b in
                              zip(marks, marks[1:]))
          + f" (before: {marks[0][1] - started:.3f}s)", file=sys.stderr)
    spans = serve.Spans()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                       else [ProfilerActivity.CPU])
        prof.__enter__()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - started
    win = loop.run(seconds, spans)
    sync(dev)
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        tr = trace.read(trace.device_intervals(prof), spans.items,
                        win.start_ns, win.end_ns)
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kept = loop.kept_cache(win)
    loop.free()
    del loop
    if cuda:
        torch.cuda.empty_cache()
    correct, compared, read = check.compare(m, cell.traffic, win, kept,
                                            seed, dev, cell.limits)
    del kept
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    run = Run(m, cell.traffic, win, setup_s, kind, tr)
    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for entry in entries:
        value = spec.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    prompts = len(win.steps) * win.batch
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": prompts, "failed": 0,
           "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = trace.breakdown(tr)
    out["check"] = compared
    return out, read
