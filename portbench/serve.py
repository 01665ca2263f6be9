"""The one traffic generator and the serving loop: a closed loop of one
client over the program's prefill entry point, ``lm_prefill`` of
``repro_torch.models.transformer``, writing a live KV-cache pool.

A traffic file (``kind`` ``prefill``) gives ``batch`` prompts of
``prompt_tokens`` token ids a request, drawn from the seed, and a pool of
``sessions`` cache slots of ``prompt_tokens`` positions, as many sessions
as a deployment keeps on the card for decode to go on from. Request i is
prefilled into the next group of ``batch`` slots in rotation, and the
client reads each prompt's next token (the greedy token at the last
position) on the host, then issues the next request.

Before the window the check's sample is drawn from the seed: ``check.rows``
prompts, each a row of one of the first ``check.within`` requests. For
those alone the loop also keeps the greedy token at every position, and
their slots leave the rotation, so that the cache they wrote is there for
the check. The window opens at the first timed issue and closes at the
completion that finds ``seconds`` gone and every sampled request done.
Every host interval of the loop is a span (``prompt``, ``issue``,
``read``), kept in memory with ``time.time_ns``.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from . import inputs

# keys of a published config that scale what the program does not scale
# (GraniteMoE's muP scalars)
UNSERVED = ("embedding_multiplier", "attention_multiplier",
            "residual_multiplier", "logits_scaling")


def lm_config(m, config: dict):
    """The program's ``LMConfig`` for reference ``Model`` ``m``; raises
    where the configuration asks for something the program does not do."""
    from repro_torch.models.transformer import LMConfig
    unserved = [k for k in UNSERVED if k in config]
    if unserved or m.eps != 1e-6:
        raise ValueError(f"{config['name']}: the program runs eps 1e-6 and "
                         f"none of {', '.join(UNSERVED)}; the configuration "
                         f"has eps {m.eps} and {unserved}")
    if config["hidden_act"] != "silu" or not config["tie_word_embeddings"]:
        raise ValueError(f"{config['name']}: the program serves a tied "
                         f"SwiGLU model here")
    return LMConfig(
        name=config["name"], n_layers=m.layers, d_model=m.d,
        n_heads=m.heads, n_kv_heads=m.kv_heads, d_ff=m.ffn, vocab=m.vocab,
        d_head=m.head_dim, n_experts=m.experts, top_k=m.top_k,
        capacity_factor=m.capacity_factor or 1.25, qk_norm=m.qk_norm,
        rope_theta=m.rope_theta, act="silu", tie_embeddings=True)


def picks(traffic: dict, seed: int) -> list:
    """The check's sample, (request, row) pairs drawn from the seed: rows
    spread evenly over the batch from a drawn offset (so that every half of
    a batch has one), each of another of the first ``check.within``
    requests where there are that many."""
    B, n = traffic["batch"], min(traffic["check"]["rows"], traffic["batch"])
    within = traffic["check"]["within"]
    rng = np.random.default_rng(inputs.sub_seed(seed, "sample"))
    first = int(rng.integers(B))
    rows = [(first + k * B // n) % B for k in range(n)]
    reqs = rng.choice(within, size=min(n, within), replace=False).tolist()
    return sorted((reqs[k % len(reqs)], b) for k, b in enumerate(rows))


class Spans:
    """Host spans (name, start_ns, end_ns) on ``time.time_ns``'s clock,
    the clock of the profiler's events."""

    def __init__(self):
        self.items: list = []

    @contextmanager
    def __call__(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t, time.time_ns()))


@dataclass
class Step:
    """One request: host times in seconds on ``perf_counter``."""
    issue: float
    issued: float
    done: float


@dataclass
class Window:
    kind: str                   # the traffic's kind
    batch: int
    tokens_each: int            # prompt tokens a prompt
    steps: list = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0
    # for the check: each sampled prompt's greedy tokens at every position
    # and the slot its cache was written to, by (request, row); the
    # served next token of every request's prompts
    greedy: dict = field(default_factory=dict)
    slot: dict = field(default_factory=dict)
    served: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Loop:
    """The cell's program state (weights and the cache pool) and its closed
    loop. ``program`` maps the entry point (the tests plant faults through
    it)."""

    def __init__(self, cfg, m, traffic: dict, params: dict, seed: int,
                 device, program=None):
        from repro_torch.models import transformer as tf
        self.cfg, self.m, self.t, self.params = cfg, m, traffic, params
        self.seed, self.device = seed, device
        self.prefill = (program or {}).get("prefill", tf.lm_prefill)
        if traffic["kind"] != "prefill":
            raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
        self.batch, self.S = traffic["batch"], traffic["prompt_tokens"]
        sessions = traffic["sessions"]
        if sessions % self.batch or \
                sessions // self.batch <= traffic["check"]["rows"]:
            raise ValueError("sessions must be a multiple of batch, with "
                             "a group in rotation besides the sampled")
        self.cache = tf.init_kv_cache(cfg, sessions, self.S, device=device)
        self.groups = deque(range(sessions // self.batch))
        self.picks = picks(traffic, seed)
        self.prompts = inputs.Prompts(m, seed, device, self.batch, self.S)

    def _view(self, group: int) -> dict:
        rows = slice(group * self.batch, (group + 1) * self.batch)
        return {k: v[:, rows] for k, v in self.cache.items()}

    def warm(self) -> None:
        """The cell's own shapes once (a request with its sampled rows
        kept), the results dropped."""
        prompts = inputs.Prompts(self.m, self.seed, self.device, self.batch,
                                 self.S, "warm")
        first = self.picks[0][0]
        group = self._prefill_one(0, prompts.next(), Window(
            "prefill", self.batch, self.S), Spans(),
            [b for r, b in self.picks if r == first])
        self.groups.appendleft(group)

    def _prefill_one(self, i: int, prompt, w: Window, spans: Spans,
                     rows: list) -> int:
        """Request ``i`` into the next group of slots, which goes back into
        the rotation unless ``rows`` are sampled; returns the group."""
        group = self.groups.popleft()
        t0 = time.perf_counter()
        with spans("issue"):
            logits = self.prefill(self.cfg, self.params, prompt,
                                  self._view(group))
        t1 = time.perf_counter()
        with spans("read"):
            head = logits[:, -1, :self.m.vocab]
            keep = [logits[b, :, :self.m.vocab].argmax(-1).to(torch.int32)
                    for b in rows]
            del logits
            w.served.append(head.argmax(-1).cpu())
        w.steps.append(Step(t0, t1, time.perf_counter()))
        for b, greedy in zip(rows, keep):
            w.greedy[(i, b)] = greedy
            w.slot[(i, b)] = group * self.batch + b
        if not rows:
            self.groups.append(group)
        return group

    def run(self, seconds: float, spans: Spans) -> Window:
        """The measured window."""
        w = Window("prefill", self.batch, self.S)
        last = max(r for r, _ in self.picks)
        w.start_ns = time.time_ns()
        start = time.perf_counter()
        i = 0
        while True:
            with spans("prompt"):
                prompt = self.prompts.next()
            self._prefill_one(i, prompt, w, spans,
                              [b for r, b in self.picks if r == i])
            i += 1
            if w.steps[-1].done - start >= seconds and i > last:
                break
        w.end_ns = time.time_ns()
        return w

    def kept_cache(self, w: Window) -> dict:
        """The cache the sampled prompts wrote, {(request, row): (k, v)},
        each [L, S, Kh, dh]: copies, so that the pool can be freed."""
        return {key: (self.cache["k"][:, s].clone(),
                      self.cache["v"][:, s].clone())
                for key, s in w.slot.items()}

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.cache = None
        self.params = None
