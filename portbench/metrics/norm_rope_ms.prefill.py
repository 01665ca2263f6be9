"""Device milliseconds a prefill request in the program's ``attn_norm``,
``qk_norm_rope`` and ``ffn_norm`` spans: each layer's two RMSNorms, and
its qk-norm and rotary embedding of q and k."""

from portbench import spans


def read(run):
    return spans.per_request_ms(run, ("attn_norm", "qk_norm_rope", "ffn_norm"))
