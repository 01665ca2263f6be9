"""Device milliseconds a prefill request in the program's ``ffn`` spans:
each layer's FFN (dense or MoE), its post norm and the residual add."""

from portbench import spans


def read(run):
    return spans.per_request_ms(run, ("ffn",))
