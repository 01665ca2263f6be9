"""``flash_tc_kernel``'s share of its roofline: the least time of the
launches the trace holds (each one layer's causal attention, bound by
operations at the bf16 peak) over their device time."""

from portbench import counts


def read(run):
    w, tr = run.window, run.trace
    peak = counts.peaks(run.device_kind)
    if tr is None or w.kind != "prefill" or peak is None:
        return None
    seconds, n = tr.op_seconds("flash_tc_kernel")
    if not n:
        return None
    least = n * counts.flash_flops(run.model, w.batch, w.tokens_each) / peak[0]
    return 100 * least / seconds
