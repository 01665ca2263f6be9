"""Device milliseconds a prefill request in the program's ``kv_write``
spans: each layer's K and V copied into the request's KV-cache slots."""

from portbench import spans


def read(run):
    return spans.per_request_ms(run, ("kv_write",))
