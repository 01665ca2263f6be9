"""Device milliseconds a prefill request in the program's ``qkv`` and
``attn_out`` spans: each layer's q, k, v and output projections, the
sandwich norm and the residual add."""

from portbench import spans


def read(run):
    return spans.per_request_ms(run, ("qkv", "attn_out"))
