"""A whole run of a cell on the CPU at a tiny size (the harness's look for a
card skipped): the result's schema, the check on the sound program, and the
check on the program with each planted fault a serving cell can have."""

import json
import time

import pytest
import torch

import _tiny
from portbench import bench, serve, spec

SEED = 2 ** 33 + 17          # the driver's seeds pass 32 bits


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(config, traffic=_tiny.PREFILL, program=None, traced=False,
        seed=SEED, seconds=0.2):
    cell = spec.Cell("tiny", 1, config, traffic, _tiny.LIMITS,
                     _tiny.END_TO_END, _tiny.PER_LAYER)
    return bench.run_cell(cell, seed, seconds, traced, "cpu",
                          time.perf_counter(), program)


@pytest.mark.parametrize("config", [_tiny.DENSE, _tiny.MOE],
                         ids=["dense", "moe"])
@pytest.mark.parametrize("seed", [SEED, 7])
def test_sound_program_is_correct(config, seed):
    out, read = run(config, seed=seed)
    assert out["correct"], read
    assert list(out)[-1] == "check"
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "check"}
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, c in out["check"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    rows, S = _tiny.PREFILL["check"]["rows"], _tiny.PREFILL["prompt_tokens"]
    assert read["positions"] == rows * S
    assert 0 < read["kv_gap"] < _tiny.LIMITS["kv_gap"]


def test_traced_run_reports_its_trace():
    out = run(_tiny.DENSE, traced=True)[0]
    assert out["correct"]
    assert set(out["metrics"]) == {"host_issue_ms.prefill",
                                   "device_idle_pct.prefill"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    json.dumps(out)


def test_window_waits_for_the_sampled_requests():
    """A window far shorter than a request still serves every request the
    check samples (the first ``within``), each into its own slots."""
    out, read = run(_tiny.DENSE, seconds=0.0)
    assert out["correct"], read
    last = max(r for r, _ in serve.picks(_tiny.PREFILL, SEED))
    assert out["attempted"] == (last + 1) * _tiny.PREFILL["batch"]


def _unwritten_cache(cfg, params, tokens, cache):
    """A prefill that returns its state unchanged: the logits, no K/V
    written."""
    from repro_torch.models import transformer as tf
    return tf.lm_prefill(cfg, params, tokens)


def _half_batch(cfg, params, tokens, cache):
    """A prefill that computes half of the batch and serves its rows to
    the other half."""
    from repro_torch.models import transformer as tf
    h = tokens.shape[0] // 2
    half = tf.lm_prefill(cfg, params, tokens[:h],
                         {k: v[:, :h] for k, v in cache.items()})
    return torch.cat([half, half])


def _altered_answer(cfg, params, tokens, cache):
    """A prefill whose greedy tokens are altered where they are produced:
    the logits rolled by one along the vocabulary."""
    from repro_torch.models import transformer as tf
    return tf.lm_prefill(cfg, params, tokens, cache).roll(1, dims=-1)


def _altered_cache(cfg, params, tokens, cache):
    """A prefill whose cache is altered where it is written: the values
    written as the keys."""
    from repro_torch.models import transformer as tf
    logits = tf.lm_prefill(cfg, params, tokens, cache)
    cache["v"].copy_(cache["k"])
    return logits


@pytest.mark.parametrize("config", [_tiny.DENSE, _tiny.MOE],
                         ids=["dense", "moe"])
@pytest.mark.parametrize("fault,number", [
    (_unwritten_cache, "kv_gap"), (_half_batch, "mean_gap"),
    (_altered_answer, "mean_gap"), (_altered_cache, "kv_gap"),
], ids=["state-unchanged", "half-batch", "answer-altered", "cache-altered"])
def test_planted_fault_is_not_correct(config, fault, number):
    out, read = run(config, program={"prefill": fault})
    assert not out["correct"], read
    assert read[number] > _tiny.LIMITS[number]
