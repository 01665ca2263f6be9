"""Device milliseconds a prefill request in the program's ``logits``
span: the final norm, the head over every position and the softcap."""

from portbench import spans


def read(run):
    return spans.per_request_ms(run, ("logits",))
