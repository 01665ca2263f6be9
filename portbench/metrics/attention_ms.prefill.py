"""Device milliseconds a prefill request in the program's ``attention``
spans: each layer's ``flash_attention`` and its output buffer."""

from portbench import spans


def read(run):
    return spans.per_request_ms(run, ("attention",))
