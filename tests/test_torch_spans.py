"""The port's span recorder (``repro_torch.spans``) in ``lm_prefill`` on
the CPU, at the tiny qwen3 and granite-moe configs of
``tests/test_torch_transformer.py``: nothing without a profiler; under
``torch.profiler`` one ``prefill`` root a call holding ``embed``, the
eight parts of each layer in order, and ``logits``; the same logits and
cache either way; and nothing recorded by ``lm_forward`` or ``lm_loss``."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs.registry import get_spec  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch import spans  # noqa: E402

LAYER = ["attn_norm", "qkv", "qk_norm_rope", "kv_write", "attention",
         "attn_out", "ffn_norm", "ffn"]


@pytest.fixture(scope="module", params=["qwen3-0.6b", "granite-moe-1b-a400m"])
def tiny(request):
    cfg = reduce_config(get_spec(request.param))
    params = ttf.init_lm_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, tokens


def _new(since: int) -> list:
    return [r for r in spans.records() if r.index >= since]


def _next_index() -> int:
    recs = spans.records()
    return recs[-1].index + 1 if recs else 0


def _prefill(cfg, params, tokens, cache=None):
    return ttf.lm_prefill(cfg, params, tokens, cache)


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn(*args)


def test_nothing_recorded_without_a_profiler(tiny):
    cfg, params, tokens = tiny
    before = len(spans.records())
    cache = ttf.init_kv_cache(cfg, 2, 24, torch.float32, "cpu")
    _prefill(cfg, params, tokens, cache)
    assert len(spans.records()) == before
    assert spans.span("qkv") is spans.NOOP
    assert spans.root("prefill", "cpu") is spans.NOOP


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "no-cache"])
def test_one_root_a_call_with_every_part_in_order(tiny, cached):
    cfg, params, tokens = tiny
    since = _next_index()
    cache = (ttf.init_kv_cache(cfg, 2, 24, torch.float32, "cpu") if cached
             else None)
    t0 = time.time_ns()
    _profiled(_prefill, cfg, params, tokens, cache)
    t1 = time.time_ns()
    recs = _new(since)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["prefill"]
    root = roots[0]
    assert {r.request for r in recs} == {root.request}
    by_index = {r.index: r for r in recs}
    children = [r for r in recs if r.parent == root.index]
    parts = LAYER if cached else [p for p in LAYER if p != "kv_write"]
    assert [r.name for r in children] == (
        ["embed"] + parts * cfg.n_layers + ["logits"])
    assert len(recs) == 1 + len(children)
    for r in recs:
        assert t0 <= r.start_ns <= r.end_ns <= t1
        assert r.device_ms == pytest.approx((r.end_ns - r.start_ns) / 1e6)
        if r.parent is not None:
            p = by_index[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns


def test_two_calls_are_two_requests(tiny):
    cfg, params, tokens = tiny
    since = _next_index()
    with profile(activities=[ProfilerActivity.CPU]):
        _prefill(cfg, params, tokens)
        _prefill(cfg, params, tokens)
    roots = [r for r in _new(since) if r.parent is None]
    assert len(roots) == 2 and roots[0].request != roots[1].request


def test_same_logits_and_cache_with_and_without_the_profiler(tiny):
    cfg, params, tokens = tiny
    c0 = ttf.init_kv_cache(cfg, 2, 24, torch.float32, "cpu")
    c1 = ttf.init_kv_cache(cfg, 2, 24, torch.float32, "cpu")
    plain = _prefill(cfg, params, tokens, c0)
    traced = _profiled(_prefill, cfg, params, tokens, c1)
    assert torch.equal(plain, traced)
    assert torch.equal(c0["k"], c1["k"]) and torch.equal(c0["v"], c1["v"])


def test_forward_and_loss_record_nothing(tiny):
    cfg, params, tokens = tiny
    since = _next_index()
    plain = ttf.lm_forward(cfg, params, tokens)
    traced = _profiled(ttf.lm_forward, cfg, params, tokens)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))

    def loss_and_grads():
        p = tree.tree_map(lambda v: v.detach().clone().requires_grad_(),
                          params)
        loss, _ = ttf.lm_loss(cfg, p, tokens)
        loss.backward()
        return loss.detach(), [v.grad for v in tree.leaves(p)]

    loss0, g0 = loss_and_grads()
    loss1, g1 = _profiled(loss_and_grads)
    assert torch.equal(loss0, loss1)
    assert all(a is not None and torch.equal(a, b) for a, b in zip(g0, g1))
    assert _new(since) == []


def test_records_are_capped_and_drops_counted(monkeypatch, tiny):
    cfg, params, tokens = tiny
    monkeypatch.setattr(spans, "CAP", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        _prefill(cfg, params, tokens)
        _prefill(cfg, params, tokens)
    # each request is more than the cap: the older one goes whole, and the
    # count of kept spans drops with it
    recs = spans.records()
    assert len({r.request for r in recs}) == 1
    assert recs[0].name == "prefill" and recs[0].parent is None
    assert spans._kept == len(recs)


def test_the_recorder_imports_nothing_of_the_program():
    """A leaf: any layer of the program may record without importing a
    layer above it."""
    code = ("import sys; import repro_torch.spans; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch')))")
    src = str(Path(spans.__file__).parents[1])
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": src}).stdout
    assert out.strip() == "['repro_torch', 'repro_torch.spans']"


class _Stamp:
    """A stand-in for ``torch.cuda.Event``: a host stamp at ``record``."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Stamp.made += 1
        self.ns = None

    def record(self):
        self.ns = time.perf_counter_ns()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


def test_event_edges_are_shared_and_pooled(monkeypatch):
    """The CUDA route's edges with stand-in events: a root takes an event
    at its start, each span one at its end, a child's start shares the
    edge before it, so abutting children sum to their parent; read events
    go back to the pool and are taken again. Stand-in stamps are host
    times, so a span's gap to its parent's end is the host's."""
    monkeypatch.setattr(torch.cuda, "Event", _Stamp)
    monkeypatch.setattr(spans, "_pool", [])
    _Stamp.made = 0

    def request():
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.root("prefill", "cuda"):
                for i in range(3):
                    with spans.span("outer"):
                        with spans.span("a"):
                            time.sleep(0.001)
                        with spans.span("b"):
                            time.sleep(0.001)

    since = _next_index()
    request()
    recs = _new(since)
    assert _Stamp.made == 1 + len(recs)      # the root's start, every end
    root, outers = recs[0], [r for r in recs if r.name == "outer"]
    assert root.parent is None and len(recs) == 10
    # the host time between a last child's end and its parent's stands in
    # for the device work there (none on the card)
    assert 0 <= root.device_ms - sum(r.device_ms for r in outers) < 0.5
    for outer in outers:
        a, b = [r for r in recs if r.parent == outer.index]
        assert 0 <= outer.device_ms - a.device_ms - b.device_ms < 0.5
        assert a.device_ms > 0.9 and b.device_ms > 0.9
    assert len(spans._pool) == _Stamp.made
    request()
    assert _Stamp.made == 11 and spans._pool == []
    assert len(_new(since)) == 20 and len(spans._pool) == 11


@pytest.mark.cuda
def test_card_spans_under_the_benchmarks_profiler():
    """On the card, under ``torch.profiler`` with the CUDA activity alone
    (the benchmark's traced run), a prefill records its spans with event
    times whose children cover their parent, and writes the same logits
    and cache as without the profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA events have no CPU mode")
    cfg = reduce_config(get_spec("qwen3-0.6b"))
    params = ttf.init_lm_params(cfg, torch.Generator("cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 256), device="cuda")
    c0 = ttf.init_kv_cache(cfg, 2, 256, device="cuda")
    c1 = ttf.init_kv_cache(cfg, 2, 256, device="cuda")
    plain = ttf.lm_prefill(cfg, params, tokens, c0)
    since = _next_index()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd._profiler_enabled()
        traced = ttf.lm_prefill(cfg, params, tokens, c1)
        torch.cuda.synchronize()
    assert torch.equal(plain, traced) and torch.equal(c0["k"], c1["k"])
    recs = _new(since)
    root = recs[0]
    assert root.name == "prefill" and len(recs) == 3 + cfg.n_layers * 8
    kids = [r for r in recs if r.parent == root.index]
    assert all(r.device_ms >= 0 for r in recs)
    assert sum(r.device_ms for r in kids) == pytest.approx(
        root.device_ms, rel=0.05)
