"""The whole prefill's share of the card's bf16 peak: the frozen count of
the completed requests' operations (``portbench.counts``) over the traced
window."""

from portbench import counts


def read(run):
    w, tr = run.window, run.trace
    peak = counts.peaks(run.device_kind)
    if tr is None or w.kind != "prefill" or peak is None:
        return None
    flops = len(w.steps) * counts.prefill_flops(run.model, w.batch,
                                                w.tokens_each)
    return 100 * flops / tr.window_s / peak[0]
