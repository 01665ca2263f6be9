"""Prompt tokens of the requests the window completed, over the window."""


def read(run):
    w = run.window
    if w.kind != "prefill":
        return None
    return len(w.steps) * w.batch * w.tokens_each / w.seconds
