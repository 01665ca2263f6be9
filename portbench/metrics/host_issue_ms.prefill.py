"""Mean host time to enqueue one prefill request: from calling
``lm_prefill`` to its return, before the greedy tokens are taken (in the
traced run)."""


def read(run):
    w = run.window
    if w.kind != "prefill" or not w.steps:
        return None
    return 1e3 * sum(s.issued - s.issue for s in w.steps) / len(w.steps)
