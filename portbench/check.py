"""How ``correct`` is decided: what the timed window served and wrote,
judged by the plain float32 reference.

After the window has closed and the program's state is freed, the sample
drawn from the seed before the window (:func:`serve.picks`: prompts of the
first requests) is run through the reference once each, over its own
prompt (inputs made again from the seed). Two things the program produced
are judged:

- the greedy token it gave at every position of the prompt (the last ones,
  where it returns fewer positions' logits): a position's gap is the
  reference's best logit less its logit of that token, 0 where the
  program chose what the reference would, small where rounding split a
  near tie;
- the cache it wrote for the prompt: each layer's keys and values, by
  :func:`reference.gap` to the reference's.

The compared numbers are the widest token gap (``worst_gap``), the mean
token gap (``mean_gap``) and the widest cache gap over layers, keys and
values (``kv_gap``); ``limits/<cell>.json`` gives the limit of each that
is compared. The control (``control``) puts the reference, in float8, in
the program's place: at the same positions it takes the token its own
logits put first, and its own keys and values stand for the cache.
"""

from __future__ import annotations

import numpy as np
import torch

from . import inputs, reference

HEAD_BLOCK = 2048        # positions a block of the LM head


def _token_gaps(m, w, h: torch.Tensor, served: torch.Tensor,
                control=None) -> torch.Tensor:
    """Gaps [n] at hidden states ``h`` [n, d] of the tokens ``served`` [n],
    or, with ``control`` (its hidden states), of the control's first
    tokens."""
    out = []
    for a in range(0, h.shape[0], HEAD_BLOCK):
        ref = reference.logits(m, w, h[a:a + HEAD_BLOCK])
        if control is None:
            pick = served[a:a + HEAD_BLOCK].long()
        else:
            pick = reference.logits(m, w, control[a:a + HEAD_BLOCK],
                                    "fp8").argmax(-1)
        out.append(ref.max(-1).values
                   - ref.gather(1, pick[:, None])[:, 0])
    return torch.cat(out)


def one(m, w, tokens, served, cache, control: bool = False):
    """(token gaps, cache gaps) of one prompt: the program's served tokens
    and its ``cache`` (k, v), each [L, n, Kh, dh], or the control's."""
    c, kept = None, []
    if control:
        c = reference.final_hidden(m, w, tokens, "fp8", keep=kept)
        cache = (lambda i: kept[i])
    else:
        k, v = cache
        cache = (lambda i: (k[i], v[i]))
    kv: list = []
    h = reference.final_hidden(m, w, tokens, against=cache, gaps=kv)
    del kept
    last = h.shape[0] - served.shape[0]     # the positions served
    return _token_gaps(m, w, h[last:], served,
                       None if c is None else c[last:]), kv


def gaps(m, traffic: dict, win, kept: dict, seed: int, device,
         control: bool = False) -> tuple[torch.Tensor, list]:
    """Token and cache gaps over the sample: ``win.greedy`` and ``kept``
    (:meth:`serve.Loop.kept_cache`) by (request, row)."""
    B, S = traffic["batch"], traffic["prompt_tokens"]
    w = inputs.weights(m, seed, device)
    prompts = inputs.Prompts(m, seed, device, B, S)
    drawn = [prompts.next() for _ in range(max(r for r, _ in win.greedy)
                                           + 1)]
    tok, kv = [], []
    for (r, b), served in sorted(win.greedy.items()):
        t, c = one(m, w, drawn[r][b], served, kept[(r, b)], control)
        tok.append(t)
        kv += c
    return torch.cat(tok), kv


def numbers(tok: torch.Tensor, kv: list) -> dict:
    return {"worst_gap": float(tok.max()), "mean_gap": float(tok.mean()),
            "kv_gap": max(kv), "positions": int(tok.numel())}


def compare(m, traffic: dict, win, kept: dict, seed: int, device,
            limits: dict, control: bool = False) -> tuple[bool, dict, dict]:
    """(correct, {name: {"value", "limit"}} of the compared numbers, every
    number read)."""
    read = numbers(*gaps(m, traffic, win, kept, seed, device, control))
    compared = {k: {"value": read[k], "limit": v} for k, v in limits.items()}
    ok = bool(win.steps) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    return ok, compared, read
