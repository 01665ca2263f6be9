"""Share of the traced window in which no kernel, copy or set ran on the
card (prefill cells)."""


def read(run):
    if run.trace is None or run.window.kind != "prefill":
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
