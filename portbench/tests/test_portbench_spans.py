"""The six readers of the program's spans (``portbench/spans.py``): on
hand-made records, only the ``prefill`` roots that started inside the
window count and the sum is over their number; a traced tiny run on the
CPU reads each; and their entries in ``BENCHMARK.json``."""

import json
import time

import pytest
import torch

import _tiny
from portbench import bench, serve, spans, spec
from repro_torch import spans as program_spans

READERS = {
    "attention_ms.prefill": ("attention",),
    "norm_rope_ms.prefill": ("attn_norm", "qk_norm_rope", "ffn_norm"),
    "ffn_ms.prefill": ("ffn",),
    "projections_ms.prefill": ("qkv", "attn_out"),
    "logits_ms.prefill": ("logits",),
    "kv_write_ms.prefill": ("kv_write",),
}
CELLS = ["qwen3-0.6b.prefill-32k", "qwen3-0.6b.prefill-4k"]


class _Run:
    def __init__(self, start_ns=100, end_ns=200, kind="prefill",
                 trace=True):
        self.window = serve.Window(kind, 1, 8, start_ns=start_ns,
                                   end_ns=end_ns)
        self.trace = object() if trace else None


def _request(request, start_ns, ms, first):
    """A root and two children: (name, device ms) pairs."""
    root = program_spans.Span(first, "prefill", request, None, start_ns,
                              start_ns + 5, sum(m for _, m in ms))
    return [root] + [program_spans.Span(first + 1 + i, name, request, first,
                                        start_ns, start_ns + 5, m)
                     for i, (name, m) in enumerate(ms)]


@pytest.fixture
def records(monkeypatch):
    recs = (_request(0, 90, [("attention", 7.0), ("ffn", 1.0)], 0)
            + _request(1, 100, [("attention", 3.0), ("ffn", 2.0)], 3)
            + _request(2, 150, [("attention", 5.0), ("ffn", 4.0)], 6)
            + _request(3, 200, [("attention", 11.0), ("ffn", 8.0)], 9))
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    return recs


def test_only_roots_started_in_the_window_count(records):
    run = _Run()
    assert spans.per_request_ms(run, ("attention",)) == 4.0
    assert spans.per_request_ms(run, ("attention", "ffn")) == 7.0
    assert spans.per_request_ms(run, ("kv_write",)) == 0.0
    assert spans.per_request_ms(_Run(90, 101), ("ffn",)) == 1.5


@pytest.mark.parametrize("run", [
    _Run(300, 400), _Run(trace=False), _Run(kind="decode")],
    ids=["no-root-in-window", "untraced", "not-prefill"])
def test_none_where_there_is_nothing_to_read(records, run):
    for name in READERS:
        assert spec.reader(name)(run) is None


def test_none_without_records(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: [])
    assert spans.per_request_ms(_Run(), ("attention",)) is None


def test_none_from_a_program_without_spans(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert spans.per_request_ms(_Run(), ("attention",)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_spans(records, name):
    want = spans.per_request_ms(_Run(), READERS[name])
    assert spec.reader(name)(_Run()) == want


@pytest.mark.parametrize("config", [_tiny.DENSE, _tiny.MOE],
                         ids=["dense", "moe"])
def test_traced_tiny_run_reads_every_part(config):
    """A traced run on the CPU: each reader a positive number, their sum
    no more than the host time a request took (on the CPU the spans'
    device time is their host time)."""
    per_layer = _tiny.PER_LAYER + [{"name": n, "unit": "ms"}
                                   for n in READERS]
    cell = spec.Cell("tiny", 1, config, _tiny.PREFILL, _tiny.LIMITS,
                     _tiny.END_TO_END, per_layer)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, read = bench.run_cell(cell, 2 ** 33 + 5, 0.2, True, "cpu",
                                   time.perf_counter())
    finally:
        torch.set_num_threads(n)
    assert out["correct"], read
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS) <= set(metrics)
    assert all(metrics[k] > 0 for k in READERS), metrics
    assert sum(metrics[k] for k in READERS) <= \
        metrics["host_issue_ms.prefill"]
    assert all(out["metrics"][k]["unit"] == "ms" for k in READERS)


def test_entries_in_benchmark_json():
    bench_json = json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench_json["per_layer"]}
    for name in READERS:
        assert entries[name] == {
            "name": name, "unit": "ms", "better": "lower",
            "source": "device_trace",
            "layer": "kernels" if name == "attention_ms.prefill"
            else "model step",
            "moves": "prefill_tokens_per_s", "workloads": CELLS}
    names = [m["name"] for m in bench_json["per_layer"]]
    assert names[-len(READERS):] == list(READERS)
    for cell in CELLS:
        got = {m["name"] for m in spec.load_cell(cell).per_layer}
        assert set(READERS) <= got
