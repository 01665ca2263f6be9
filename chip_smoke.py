#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --lm-only --prefill-seq 4096 --decode-cache 4096
                                     # LM phase alone, short (kernel edits)

1. Builds the CUDA kernels of ``src/repro_torch/csrc`` with ``nvcc``, one
   process per source, all started together.
2. SPARQL serving, full size: a WatDiv-like graph of about 10M triples
   (``generate_watdiv_like(scale=1000)``) behind ``repro_torch.SparqlEndpoint``
   on ``cuda``; one cold and one warm ``query_many`` over a query mix, every
   answer held against the port's ``NumpyBackend`` as multisets, the host
   transfer contract (2 cold, 0 warm), every kernel launched at least once,
   and ``MatchCapacityError`` on both backends for a star2 query.
3. The same on a 4-shard store at scale 100.
4. Each query kernel held against its plain torch version on the card at
   the serving shapes and on edge cases (exact equality: all results are
   integers), and timed beside its bound.
5. LM serving, qwen3-0.6b at full width (random weights from ``--seed``):
   full-width float32 prefill and decode on the card against the same
   weights on the CPU; a bf16 prefill of 32,768 tokens; 64 greedy bf16
   decode steps of 8 sequences against a 32,768-position KV cache; decode
   logits against prefill logits on a short prompt; ``flash_attention``
   and ``decode_attention`` held against their plain versions (qwen3 and
   gemma2 head shapes, ragged lengths, GQA groups) and timed beside their
   bounds at the serving shapes.

Fails (non-zero exit, no result line) on any mismatch or exception, and
when CUDA is not available. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MIX_TEMPLATES = ["chain2", "chain3", "complex", "anchored_star",
                 "anchored_chain"]
SINGLE_PATTERN = "SELECT ?x ?c WHERE { ?x <country> ?c }"
CAPACITY_TEMPLATE = "star2"
# HBM rate of the SKU nvidia-smi names (NVIDIA data sheets), bytes/s
HBM_BYTES_PER_S = [("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12)]
# int32 compares run on the CUDA cores: the H100 SXM's non-tensor-core
# float32 peak (NVIDIA data sheet), ops/s
SCALAR_OPS_PER_S = 67e12
KERNEL_SOURCE = "src/repro_torch/csrc/rdf_kernels.cu"
REPLACES = {
    "triple_scan": "src/repro/kernels/triple_scan.py:60",
    "triple_scan_many": "src/repro/kernels/triple_scan.py:102",
    "probe_sorted_many": "src/repro/kernels/join_probe.py:96",
    "scan_probe": "src/repro/kernels/join_probe.py:184",
}
LM_ARCH = "qwen3-0.6b"
# batch cuts of the registry's prefill_32k (32 -> 1: 32 sequences' logits
# alone are 319 GB) and decode_32k (128 -> 8: 128 caches are 481 GB)
PREFILL_BATCH = 1
DECODE_BATCH = 8
PREFILL_WARM = 4096          # tokens of the untimed first prefill
CONSISTENCY_PROMPT = 64      # tokens of the decode-vs-prefill check
ATTN_SOURCE = "src/repro_torch/csrc/attention_kernels.cu"
LM_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:112",
    "decode_attention": "src/repro/kernels/decode_attention.py:111",
}
# dense bf16 tensor-core peak of the H100 SXM (NVIDIA data sheet), FLOP/s
BF16_OPS_PER_S = 989e12
# kernel against plain version, per element and by dtype: |kernel - plain|
# <= atol + rtol * |plain|. Both sum in float32 (in another order) and
# round once to the output's dtype, so bfloat16 adds at most one unit in
# the last place, 2^-7 of |plain|; atol covers the float32 sums (about
# 1e-6 apart on an H100).
ATTN_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-5, 2.0 ** -7)}
# f32 card-vs-CPU logits and bf16 decode-vs-prefill logits, relative to
# max(1, max |logit|); each run also reads a control (TF32 matmuls; the
# current token left out of decode attention) that must exceed its limit
MODEL_TOL = 2e-5
CONSISTENCY_TOL = 0.05
PLANTED_DROP = 64            # keys a planted attention fault leaves out


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sorted_rows(table) -> np.ndarray:
    """Solution multiset as rows sorted lexicographically, columns in
    variable-name order."""
    order = sorted(table.var_names)
    rows = table.bindings[:, [table.var_names.index(v) for v in order]]
    if len(rows) == 0:
        return rows
    return rows[np.lexsort(rows.T[::-1])]


def same_answer(a, b) -> bool:
    if sorted(a.var_names) != sorted(b.var_names):
        return False
    return np.array_equal(sorted_rows(a), sorted_rows(b))


def query_mix(gen, n_queries: int, seed: int) -> list[str]:
    from repro_torch.rdf.generator import workload_sparql
    return workload_sparql(gen, n_queries, seed=seed,
                           templates=MIX_TEMPLATES) + [SINGLE_PATTERN]


def serve(store, dictionary, texts: list[str], capacity_text: str,
          device, max_rows: int) -> dict:
    """One cold and one warm ``query_many`` on the torch endpoint, held
    against the numpy endpoint; then the capacity query on both.

    Returns the phase's counters; raises on any mismatch."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sparql.endpoint import SparqlEndpoint
    from repro_torch.sparql.engine import QueryEngine, TorchBackend
    from repro_torch.sparql.matcher import MatchCapacityError

    backend = TorchBackend(device=device)
    ep = SparqlEndpoint(store, dictionary, engine=QueryEngine(
        backend=backend, max_rows=max_rows))
    ref = SparqlEndpoint(store, dictionary, engine=QueryEngine(
        backend="numpy", max_rows=max_rows))
    st = ep.stats

    reset_launch_counts()
    x0, b0, s0 = st.host_transfers, st.host_transfer_bytes, st.scalar_syncs
    e0 = st.scans_executed
    t0 = time.perf_counter()
    cold = ep.query_many(texts)
    _sync(device)
    cold_s = time.perf_counter() - t0
    x1, b1, s1 = st.host_transfers, st.host_transfer_bytes, st.scalar_syncs
    e1 = st.scans_executed
    phases = {"prescan_s": st.prescan_seconds, "join_s": st.join_seconds,
              "engine_s": st.exec_seconds}
    t0 = time.perf_counter()
    warm = ep.query_many(texts)
    _sync(device)
    warm_s = time.perf_counter() - t0
    x2 = st.host_transfers
    launches = launch_counts()

    # steady cold batch: caches dropped, staged tables and sorted views kept
    ep.clear_cache()
    t0 = time.perf_counter()
    ep.query_many(texts)
    _sync(device)
    recold_s = time.perf_counter() - t0
    profile = (device_profile(lambda: _steady_cold(ep, texts))
               if backend.device.type == "cuda" else None)

    t0 = time.perf_counter()
    want = ref.query_many(texts)
    ref_s = time.perf_counter() - t0
    bad = [t for t, a, w, b in zip(texts, cold, warm, want)
           if not (same_answer(a, b) and same_answer(w, b))]
    if bad:
        raise AssertionError(f"{len(bad)} answers differ from the numpy "
                             f"backend, first: {bad[0]}")
    if st.backend_mode != f"torch-{backend.device.type}":
        raise AssertionError(f"backend_mode is {st.backend_mode}")
    if (x1 - x0, x2 - x1) != (2, 0):
        raise AssertionError(f"host transfers cold {x1 - x0}, warm "
                             f"{x2 - x1}; want 2 and 0")
    if not (st.device_queries and st.device_fallbacks):
        raise AssertionError("the mix must take both the device and the "
                             "host route")
    for name, e in (("torch", ep), ("numpy", ref)):
        try:
            e.query(capacity_text)
        except MatchCapacityError:
            continue
        raise AssertionError(f"{name} backend: no MatchCapacityError above "
                             f"max_rows={max_rows}")
    return {
        "queries": len(texts), "distinct": len(set(texts)),
        "rows": sum(t.num_matches for t in cold),
        "cold_s": cold_s, "recold_s": recold_s, "warm_s": warm_s,
        "numpy_s": ref_s, "cold_qps": len(texts) / cold_s,
        "recold_qps": len(texts) / recold_s, "warm_qps": len(texts) / warm_s,
        "numpy_qps": len(texts) / ref_s, "profile": profile,
        "backend_mode": st.backend_mode,
        "device_queries": st.device_queries,
        "device_fallbacks": st.device_fallbacks,
        "host_transfers_cold": x1 - x0, "host_transfers_warm": x2 - x1,
        "host_transfer_bytes_cold": b1 - b0, "scalar_syncs_cold": s1 - s0,
        "scans_executed_cold": e1 - e0, "cold_phases": phases,
        "launches": launches, "backend": backend,
    }


def device_profile(fn) -> dict:
    """Device time of one ``fn()`` under ``torch.profiler``: the sum over
    kernels and copies, its share of the call's wall time (which the
    profiler itself inflates), and the largest items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    items = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                    for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")), reverse=True)
    device_ms = sum(ms for ms, _, _ in items)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [[key[:60], ms, n] for ms, key, n in items[:8]]}


def _steady_cold(ep, texts: list[str]) -> None:
    ep.clear_cache()
    ep.query_many(texts)


# ---------------------------------------------------------------------------
# kernel phase (card only)
# ---------------------------------------------------------------------------


def time_ms(fn, calls: int = 5, reps: int = 7) -> float:
    """Median over ``reps`` of the mean time of ``calls`` back-to-back
    calls, between CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
                                 f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return err


def check_edge_cases(dev) -> int:
    """Exact agreement with the plain versions on the contract's edges;
    returns the number of cases checked."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.join_probe import probe_sorted_many, scan_probe
    from repro_torch.kernels.triple_scan import triple_scan, triple_scan_many

    rng = np.random.default_rng(0)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    cases = 0
    edge_probes = np.asarray([-1, -7, 0, 2 ** 31 - 1, 10 ** 6], np.int32)
    for K in (0, 1, 7, 256, 1000, 4097):            # empty keys, duplicates
        keys = t32(np.sort(rng.integers(0, 50, K)) if K != 4097
                   else np.full(K, 7))                # one run of K keys
        probes = t32(np.concatenate([rng.integers(-5, 60, (3, 333)),
                                     np.tile(edge_probes, (3, 1))], axis=1))
        if max_abs_err(probe_sorted_many(keys, probes),
                       ref.probe_sorted_reference(keys, probes)):
            raise AssertionError(f"probe_sorted_many differs at K={K}")
        cases += 1
    for T in (1, 255, 257, 100_003):                # T off the block size
        tri = t32(rng.integers(0, 40, (T, 3)))
        keys = t32(np.sort(rng.integers(0, 40, 77)))
        for pat in [(-1, 3, -1), (-1, -1, -1), (7, 2, -1), (1, 2, 3)]:
            if max_abs_err(triple_scan(tri, pat),
                           ref.triple_scan_reference(tri, *pat)):
                raise AssertionError(f"triple_scan differs at T={T} {pat}")
            for col in (0, 2):
                for k in (keys, keys[:0]):
                    if max_abs_err(scan_probe(tri, pat, k, col),
                                   ref.scan_probe_reference(tri, *pat, k,
                                                            col)):
                        raise AssertionError(
                            f"scan_probe differs at T={T} {pat} col={col}")
            cases += 5
        # more patterns than one shared-memory chunk holds
        pats = t32(rng.integers(-1, 40, (1100, 3)))
        if max_abs_err(triple_scan_many(tri, pats),
                       ref.triple_scan_many_reference(tri, pats)):
            raise AssertionError(f"triple_scan_many differs at T={T}")
        cases += 1
    try:
        scan_probe(t32(np.zeros((8, 3))), (-1, -1, -1), t32(np.zeros(4)),
                   col=1)
    except ValueError:
        cases += 1
    else:
        raise AssertionError("scan_probe accepted col=1")
    torch.cuda.synchronize()
    return cases


def kernel_phase(store, dictionary, backend, serving: dict,
                 hbm: float) -> list[dict]:
    """Each kernel at the serving phase's shapes, against its plain
    version on the same card inputs, timed beside its bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.join_probe import probe_sorted_many, scan_probe
    from repro_torch.kernels.triple_scan import triple_scan, triple_scan_many

    triples = backend._triples(store)                 # the staged [T, 3]
    T = triples.shape[0]
    follows = dictionary.predicate_id("follows")
    country = dictionary.predicate_id("country")
    # a follows-follows chain join: keys = the sorted subjects, probes =
    # every follows triple's object
    views, _off, _flat = backend._pred_views(store, follows)
    keys = views[0]
    K = keys.shape[0]
    probes = triples[torch.from_numpy(store.pred_tids(follows)).to(
        triples.device), 2].contiguous()[None, :]
    P = probes.shape[1]
    # the host route's fused prescan: one (-1, country, C) row per
    # distinct scan the cold batch executed
    Q = max(1, serving["scans_executed_cold"])
    consts = np.unique(store.o[store.pred_tids(country)])[:Q]
    pats = torch.tensor([[-1, country, int(c)] for c in consts],
                        dtype=torch.int32, device=triples.device)
    Q = pats.shape[0]
    scan_pat = (-1, country, -1)
    probe_pat = (-1, follows, -1)
    steps = math.ceil(math.log2(K + 1))

    specs = [
        ("triple_scan", lambda: triple_scan(triples, scan_pat),
         lambda: ref.triple_scan_reference(triples, *scan_pat), None,
         16 * T, 3 * T, f"T={T}"),
        ("triple_scan_many", lambda: triple_scan_many(triples, pats),
         lambda: ref.triple_scan_many_reference(triples, pats), None,
         12 * T + 12 * Q + 4 * Q * T, 3 * Q * T, f"T={T} Q={Q}"),
        ("probe_sorted_many", lambda: probe_sorted_many(keys, probes),
         lambda: ref.probe_sorted_reference(keys, probes),
         lambda: (torch.searchsorted(keys, probes, out_int32=True),
                  torch.searchsorted(keys, probes, right=True,
                                     out_int32=True)),
         4 * K + 12 * P, 2 * P * steps, f"K={K} P={P}"),
        ("scan_probe", lambda: scan_probe(triples, probe_pat, keys, 2),
         lambda: ref.scan_probe_reference(triples, *probe_pat, keys, 2),
         None, 24 * T + 4 * K, 3 * T + 2 * T * steps, f"T={T} K={K}"),
    ]
    rows = []
    for name, kern, plain, lib, nbytes, ops, shape in specs:
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"{name}: max |kernel - plain| = {err}")
        t_bytes, t_ops = nbytes / hbm * 1e3, ops / SCALAR_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": int(serving["launches"].get(name, 0)),
            "max_abs_err": err, "ms": time_ms(kern),
            "plain_ms": time_ms(plain, calls=2, reps=3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib) if lib is not None else None,
        }
        rows.append(row)
        log(f"kernel {name} [{shape}]: kernel_ms={row['ms']} "
            f"bound_ms={row['bound_ms']} ({row['bound_by']}) "
            f"plain_ms={row['plain_ms']} library_ms={row['library_ms']} "
            f"launches={row['launches']} max_abs_err={err}")
    return rows


# ---------------------------------------------------------------------------
# LM serving phase
# ---------------------------------------------------------------------------


def _tokens(seed: int, shape: tuple[int, ...], vocab: int, device):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=g).to(device)


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _peak_gb(device) -> float | None:
    import torch
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 1e9


def _reset_peak(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def lm_model_check(cfg, seed: int, device, prompt: int = 128,
                   steps: int = 16, ref_device="cpu") -> dict:
    """Float32 weights from ``seed``: a prefill of ``prompt`` tokens and
    ``steps`` decode steps from an empty cache on ``device`` (through the
    kernels on a card), then the same weights and tokens on ``ref_device``
    (the plain versions on the CPU). ok when every logit is finite and
    max |diff| <= MODEL_TOL * max(1, max |logit|). On a card the control
    runs the card side again with TF32 matmuls; ok also needs its diff
    above the limit, or the check could not see such a fault."""
    import torch
    from repro_torch.models.transformer import (init_kv_cache, init_lm_params,
                                                lm_decode_step, lm_prefill)
    dev = torch.device(device)
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), torch.float32, dev)
    tokens = _tokens(seed, (1, prompt), cfg.vocab, "cpu")

    def run(p, d):
        pre = lm_prefill(cfg, p, tokens.to(d))
        cache = init_kv_cache(cfg, 1, steps, torch.float32, d)
        dec = [lm_decode_step(cfg, p, cache, tokens[:, t:t + 1].to(d), t)[0]
               for t in range(steps)]
        return pre.cpu(), torch.cat(dec, dim=1).cpu()

    def diff(got):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    got = run(params, dev)
    ref_dev = torch.device(ref_device)
    want = run(_params_to(params, ref_dev), ref_dev)
    scale = max(float(w.abs().max()) for w in want)
    limit = MODEL_TOL * max(1.0, scale)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    control = None
    if dev.type == "cuda":
        matmul = torch.backends.cuda.matmul
        tf32, matmul.allow_tf32 = matmul.allow_tf32, True
        try:
            control = diff(run(params, dev))
        finally:
            matmul.allow_tf32 = tf32
    return {"prompt": prompt, "steps": steps, "max_abs_diff": diff(got),
            "max_abs_logit": scale, "limit": limit,
            "tf32_control_diff": control,
            "ok": finite and diff(got) <= limit
            and (control is None or control > limit)}


def lm_prefill_phase(cfg, params, seq: int, batch: int, warm_seq: int,
                     seed: int, device, profile: bool = False) -> dict:
    """One untimed prefill of ``warm_seq`` tokens, then one timed prefill
    of [batch, seq] tokens; the launch counts are set to 0 just before the
    timed pass and read just after. ``profile`` adds a profiled pass."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import lm_prefill
    tokens = _tokens(seed + 1, (batch, seq), cfg.vocab, device)
    lm_prefill(cfg, params, tokens[:, :warm_seq])
    _reset_peak(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    logits = lm_prefill(cfg, params, tokens)
    _sync(device)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    out = {"batch": batch, "seq": seq, "tokens": batch * seq,
           "dtype": str(logits.dtype).removeprefix("torch."),
           "seconds": dt, "tokens_per_s": batch * seq / dt,
           "launches": launches, "peak_gb": _peak_gb(device)}
    if logits.shape != (batch, seq, cfg.padded_vocab):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    if not all(bool(torch.isfinite(c).all())
               for c in logits.split(1024, dim=1)):
        raise AssertionError("prefill logits are not all finite")
    del logits
    if profile:                          # a second pass, under the profiler
        out["profile"] = device_profile(lambda: lm_prefill(cfg, params,
                                                           tokens))
    return out


def lm_decode_phase(cfg, params, batch: int, cache_len: int, steps: int,
                    seed: int, device, profile: int = 0) -> dict:
    """A KV cache of ``cache_len`` positions whose first ``cache_len -
    steps`` are filled from ``seed``, then ``steps`` greedy decode steps
    that fill the rest; the launch counts are set to 0 just before the
    steps and read just after. ``profile`` > 0 repeats that many of the
    last steps (rewriting their positions) under the profiler."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_kv_cache, lm_decode_step
    dev = torch.device(device)
    cache = init_kv_cache(cfg, batch, cache_len, params["embed"].dtype, dev)
    fill = cache_len - steps
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    for name in ("k", "v"):
        for layer in range(cfg.n_layers):
            cache[name][layer, :, :fill].normal_(generator=gen)
    tok = _tokens(seed + 3, (batch, 1), cfg.vocab, dev)
    _reset_peak(dev)
    cuda = dev.type == "cuda"
    marks = []
    reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        logits, cache = lm_decode_step(cfg, params, cache, tok, fill + i)
        tok = logits[:, -1, :cfg.vocab].argmax(dim=-1, keepdim=True)
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode logits are not all finite")
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    out = {"batch": batch, "cache_len": cache_len, "filled": fill,
           "steps": steps, "final_length": fill + steps,
           "seconds": dt, "ms_per_step": dt * 1e3 / steps,
           "median_step_ms": statistics.median(step_ms) if step_ms
           else None, "tokens_per_s": batch * steps / dt,
           "launches": launches, "peak_gb": _peak_gb(dev)}

    def again():
        for pos in range(cache_len - profile, cache_len):
            lm_decode_step(cfg, params, cache, tok, pos)

    if profile:
        out["profile"] = device_profile(again)
        out["profile"]["steps"] = profile
    return out


def lm_consistency(cfg, params, prompt: int, seed: int, device) -> dict:
    """Decode against prefill on one prompt: prefill its first half into a
    cache, decode the second half token by token, and compare those
    logits with a prefill of the whole prompt. The control decodes again
    with a planted off-by-one: each step's attention leaves out the
    current token (valid lengths ``pos`` instead of ``pos + 1``)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.transformer import (init_kv_cache,
                                                lm_decode_step, lm_prefill)
    tokens = _tokens(seed + 4, (1, prompt), cfg.vocab, device)
    want = lm_prefill(cfg, params, tokens)[:, prompt // 2:].float()
    half = prompt // 2

    def decode():
        cache = init_kv_cache(cfg, 1, prompt, params["embed"].dtype, device)
        lm_prefill(cfg, params, tokens[:, :half], cache)
        return torch.cat([lm_decode_step(cfg, params, cache,
                                         tokens[:, t:t + 1], t)[0]
                          for t in range(half, prompt)], dim=1).float()

    got = decode()
    kernel = transformer.decode_attention
    transformer.decode_attention = (
        lambda q, k, v, lengths, **kw: kernel(q, k, v, lengths - 1, **kw))
    try:
        planted = decode()
    finally:
        transformer.decode_attention = kernel
    return {"prompt": prompt, "decoded": prompt - half,
            "max_abs_diff": float((got - want).abs().max()),
            "max_abs_logit": float(want.abs().max()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean()),
            "off_by_one_control_diff": float((planted - want).abs().max())}


def _attn_inputs(gen, B, H, Hkv, S, d, dtype, dev, layout="bshd"):
    """q [B,H,S,d] and k/v [B,Hkv,S,d]; with layout "bshd" they are
    transposed views of [B,S,heads,d] tensors, as the model passes them."""
    import torch

    def one(heads):
        if layout == "bshd":
            return torch.randn((B, S, heads, d), generator=gen, device=dev,
                               dtype=dtype).transpose(1, 2)
        return torch.randn((B, heads, S, d), generator=gen, device=dev,
                           dtype=dtype)

    return one(H), one(Hkv), one(Hkv)


def attn_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (atol + rtol * |want|)) with
    the tolerance of want's dtype: within tolerance when the second is
    at most 1."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    if not got.numel():
        return 0.0, 0.0
    atol, rtol = ATTN_TOL[str(want.dtype).removeprefix("torch.")]
    w = want.float()
    delta = (got.float() - w).abs()
    return (float(delta.max()),
            float((delta / (atol + rtol * w.abs())).max()))


def check_attention_cases(dev, dtypes=("float32", "bfloat16")) -> dict:
    """Both attention kernels against their plain versions on the card:
    ragged S, GQA groups of 1, 2 and 8, every compiled head dim, windows,
    softcaps, lengths at tile and chunk edges and 0 (exact zeros),
    strided and contiguous inputs. Returns the number of cases and, by
    dtype, the largest ``attn_err`` readings; raises after every case
    has run if any was out of tolerance."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import CHUNK, decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(7)
    flash_cases = [  # B, H, Hkv, S, d, window, softcap
        (1, 2, 2, 1, 64, 0, 0.0), (2, 4, 2, 37, 128, 0, 0.0),
        (1, 8, 1, 1000, 32, 0, 30.0), (2, 8, 8, 1000, 16, 100, 0.0),
        (1, 4, 2, 300, 256, 64, 50.0), (1, 16, 2, 130, 128, 0, 0.0),
        (1, 16, 8, 4096, 128, 0, 0.0),          # qwen3 heads
        (1, 8, 4, 8192, 256, 4096, 50.0),       # gemma2 heads, local layer
    ]
    lengths_edge = [1, 31, 32, 33, CHUNK - 1, CHUNK, CHUNK + 1, 0]
    decode_cases = [  # B, H, Hkv, S, d, window, softcap
        (9, 2, 2, 1100, 64, 0, 0.0), (9, 4, 2, 1100, 128, 300, 50.0),
        (9, 16, 2, 1100, 32, 0, 0.0), (9, 8, 1, 1100, 16, 0, 30.0),
        (9, 8, 4, 1100, 256, 0, 0.0),
        (4, 16, 8, 4096, 128, 0, 0.0),          # qwen3 heads
        (4, 8, 4, 8192, 256, 4096, 50.0),       # gemma2 heads, local layer
    ]
    worst, bad = {}, []

    def record(label, dtype, got, want):
        err, ratio = attn_err(got, want)
        w = worst.setdefault(dtype, {"max_abs_err": 0.0, "max_ratio": 0.0})
        w["max_abs_err"] = max(w["max_abs_err"], err)
        w["max_ratio"] = max(w["max_ratio"], ratio)
        if not ratio <= 1.0:
            bad.append(f"{label}: max |kernel - plain| {err}, {ratio}x the "
                       f"tolerance")

    for name in dtypes:
        dtype = getattr(torch, name)
        for i, (B, H, Hkv, S, d, win, cap) in enumerate(flash_cases):
            layout = "bshd" if i % 2 == 0 else "bhsd"
            q, k, v = _attn_inputs(gen, B, H, Hkv, S, d, dtype, dev, layout)
            record(f"flash_attention {name} {flash_cases[i]}", name,
                   flash_attention(q, k, v, window=win, softcap=cap),
                   ref.mha_reference(q, k, v, True, win, cap))
        for i, (B, H, Hkv, S, d, win, cap) in enumerate(decode_cases):
            layout = "bshd" if i % 2 == 0 else "bhsd"
            _, k, v = _attn_inputs(gen, B, H, Hkv, S, d, dtype, dev, layout)
            q = torch.randn((B, H, d), generator=gen, device=dev,
                            dtype=dtype)
            lens = (lengths_edge + [S] if B == len(lengths_edge) + 1
                    else [1, S // 2 + 1, S - 1, S])
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = decode_attention(q, k, v, lengths, window=win, softcap=cap)
            label = f"decode_attention {name} {decode_cases[i]} {lens}"
            record(label, name, out,
                   ref.decode_reference(q, k, v, lengths, win, cap))
            if 0 in lens and out[lens.index(0)].any():
                bad.append(f"{label}: length 0 gives non-zeros")
    torch.cuda.synchronize()
    if bad:
        raise AssertionError("; ".join(bad))
    return {"cases": len(dtypes) * (len(flash_cases) + len(decode_cases)),
            **worst}


def _sdpa(q, k, v, causal: bool):
    """One ``scaled_dot_product_attention`` call computing the same
    function (the yardstick, never used by the port), restricted to the
    fused backends; ``None`` where none of them takes these inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def call(kk, vv, **kw):
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(q, kk, vv,
                                                  is_causal=causal, **kw)

    G = q.shape[1] // k.shape[1]
    try:
        call(k, v, enable_gqa=True)
        torch.cuda.synchronize()
        return lambda: call(k, v, enable_gqa=True), "enable_gqa"
    except (RuntimeError, TypeError) as exc:
        log(f"sdpa with enable_gqa refused ({str(exc)[:120]}); timing it "
            f"on k/v expanded to {q.shape[1]} heads beforehand")
    ke = k.repeat_interleave(G, dim=1).contiguous()
    ve = v.repeat_interleave(G, dim=1).contiguous()
    try:
        call(ke, ve)
        torch.cuda.synchronize()
        return lambda: call(ke, ve), "expanded heads"
    except RuntimeError as exc:
        log(f"sdpa refused ({str(exc)[:120]}): library_ms null")
        return None, None


def attention_kernel_rows(cfg, prefill: dict, decode: dict,
                          hbm: float) -> list[dict]:
    """Both attention kernels at the serving shapes of the prefill and
    decode phases (bf16, the model's strided layouts), against their plain
    versions on the same card inputs, timed beside their bounds and one
    PyTorch call of the same function."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    dt = torch.bfloat16
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rows = []

    B, S = prefill["batch"], prefill["seq"]
    q, k, v = _attn_inputs(gen, B, H, Hkv, S, d, dt, dev)
    pairs = B * H * S * (S + 1) // 2                  # causal (q, k) pairs
    flops = 4 * d * pairs
    nbytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
    lib, how = _sdpa(q.contiguous(), k.contiguous(), v.contiguous(), True)
    rows.append(_attn_row(
        "flash_attention", lambda: flash_attention(q, k, v),
        lambda: ref.mha_reference(q, k, v),
        lambda: ref.mha_reference(q, k, v, True, max(1, S - PLANTED_DROP)),
        lib, how, flops, nbytes, hbm, prefill["launches"],
        f"B={B} H={H} Hkv={Hkv} S={S} d={d} bf16", calls=1, reps=3))
    del q, k, v

    B, S = decode["batch"], decode["cache_len"]
    _, k, v = _attn_inputs(gen, B, H, Hkv, S, d, dt, dev)
    q = torch.randn((B, H, d), generator=gen, device=dev, dtype=dt)
    n = decode["final_length"]
    lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    nbytes = 2 * (2 * B * Hkv * n * d + 2 * B * H * d)
    flops = 4 * B * H * d * n
    lib, how = _sdpa(q[:, :, None], k[:, :, :n], v[:, :, :n], False)
    rows.append(_attn_row(
        "decode_attention",
        lambda: decode_attention(q, k, v, lengths),
        lambda: ref.decode_reference(q, k, v, lengths),
        lambda: ref.decode_reference(q, k, v, lengths,
                                     max(1, n - PLANTED_DROP)),
        (lambda: lib()[:, :, 0]) if lib else None, how, flops, nbytes, hbm,
        decode["launches"], f"B={B} H={H} Hkv={Hkv} S={S} length={n} d={d} "
        f"bf16", calls=5, reps=7))
    return rows


def _attn_row(name, kern, plain, planted, lib, how, flops, nbytes, hbm,
              launches, shape, calls, reps) -> dict:
    """``planted``: the plain version with a fault planted (the first
    PLANTED_DROP keys of the longest rows left out); the check must find
    it out of tolerance, or it could not see such a kernel fault."""
    import torch
    want = plain()
    err, ratio = attn_err(kern(), want)
    control_err, control = attn_err(planted(), want)
    torch.cuda.synchronize()
    if not ratio <= 1.0:
        raise AssertionError(f"{name} [{shape}]: max |kernel - plain| = "
                             f"{err}, {ratio}x the tolerance")
    if not control > 1.0:
        raise AssertionError(f"{name} [{shape}]: a planted fault is within "
                             f"tolerance ({control}x)")
    lib_err = attn_err(lib(), want)[0] if lib is not None else None
    del want
    t_bytes, t_ops = nbytes / hbm * 1e3, flops / BF16_OPS_PER_S * 1e3
    row = {
        "name": name, "route": "cuda", "source": ATTN_SOURCE,
        "replaces": LM_REPLACES[name],
        "launches": int(launches.get(name, 0)), "max_abs_err": err,
        "ms": time_ms(kern, calls=calls, reps=reps),
        "plain_ms": time_ms(plain, calls=1, reps=1),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_ms(lib, calls=calls, reps=reps) if lib else None,
    }
    log(f"kernel {name} [{shape}]: kernel_ms={row['ms']} "
        f"bound_ms={row['bound_ms']} ({row['bound_by']}) "
        f"plain_ms={row['plain_ms']} library_ms={row['library_ms']} "
        f"({how}, max |library - plain| {lib_err}) "
        f"launches={row['launches']} max_abs_err={err} ({ratio}x the "
        f"tolerance; planted fault {control_err}, {control}x)")
    return row


def lm_phase(args, hbm: float | None, device) -> list[dict]:
    """The LM serving phase at full width; returns the attention kernels'
    rows (none off the card)."""
    import torch
    from repro_torch.configs.registry import LM_SHAPES, get_spec
    from repro_torch.models.transformer import init_lm_params

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 checks
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_spec(LM_ARCH).config
    L = cfg.n_layers
    log(f"lm: {cfg.name} {L} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d_head {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.padded_vocab}), "
        f"{cfg.param_count()} parameters; shapes {LM_SHAPES['prefill_32k']} "
        f"and {LM_SHAPES['decode_32k']} cut as the flags say")

    t0 = time.perf_counter()
    check = lm_model_check(cfg, args.seed, device)
    log(f"lm model check (f32, card vs CPU): {json.dumps(check)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if not check["ok"]:
        raise AssertionError(f"f32 logits differ: {check}")

    params = init_lm_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), torch.bfloat16, device)
    pre = lm_prefill_phase(cfg, params, args.prefill_seq, PREFILL_BATCH,
                           min(PREFILL_WARM, args.prefill_seq), args.seed,
                           device, profile=True)
    log(f"lm prefill: {json.dumps(pre)}")
    torch.cuda.empty_cache()
    dec = lm_decode_phase(cfg, params, DECODE_BATCH, args.decode_cache,
                          args.decode_steps, args.seed, device, profile=4)
    log(f"lm decode: {json.dumps(dec)}")
    torch.cuda.empty_cache()
    want = {"flash_attention": L, "decode_attention": L * args.decode_steps}
    got = {"flash_attention": pre["launches"].get("flash_attention", 0),
           "decode_attention": dec["launches"].get("decode_attention", 0)}
    if got != want:
        raise AssertionError(f"attention launches {got}, want {want}")
    cons = lm_consistency(cfg, params, CONSISTENCY_PROMPT, args.seed, device)
    cons["limit"] = CONSISTENCY_TOL * max(1.0, cons["max_abs_logit"])
    log(f"lm decode vs prefill (bf16): {json.dumps(cons)}")
    if not cons["max_abs_diff"] <= cons["limit"]:
        raise AssertionError(f"bf16 decode logits drift from prefill: "
                             f"{cons}")
    if not cons["off_by_one_control_diff"] > cons["limit"]:
        raise AssertionError(f"a planted off-by-one is within the decode "
                             f"limit: {cons}")
    del params
    torch.cuda.empty_cache()

    cases = check_attention_cases(device)
    log(f"attention edge cases within (atol, rtol) {ATTN_TOL}: "
        f"{json.dumps(cases)}")
    return attention_kernel_rows(cfg, pre, dec, hbm)



def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM rate on record for {name!r}")


def run_phase(label: str, gen, store, n_queries: int, max_rows: int,
              device) -> dict:
    from repro_torch.rdf.generator import workload_sparql
    texts = query_mix(gen, n_queries, seed=1)
    capacity = workload_sparql(gen, 1, seed=2,
                               templates=[CAPACITY_TEMPLATE])[0]
    res = serve(store, gen.dictionary, texts, capacity, device, max_rows)
    launches = res["launches"]
    missing = [k for k in REPLACES if launches.get(k, 0) <= 0]
    if res["backend"].device.type == "cuda" and missing:
        raise AssertionError(f"{label}: kernels not launched on the main "
                             f"path: {missing}")
    shown = {k: v for k, v in res.items() if k != "backend"}
    log(f"serving {label}: {json.dumps(shown)}")
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1000.0)
    ap.add_argument("--sharded-scale", type=float, default=100.0)
    ap.add_argument("--queries", type=int, default=24)
    ap.add_argument("--max-rows", type=int, default=5_000_000,
                    help="engine row cap of the full-size phase")
    ap.add_argument("--sharded-max-rows", type=int, default=500_000,
                    help="engine row cap of the sharded phase")
    ap.add_argument("--lm-only", action="store_true",
                    help="skip the SPARQL phases (a short run after an "
                         "attention kernel edit)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LM phase's weights, tokens and cache")
    ap.add_argument("--prefill-seq", type=int, default=32768)
    ap.add_argument("--decode-cache", type=int, default=32768)
    ap.add_argument("--decode-steps", type=int, default=64)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build
    from repro_torch.rdf.generator import generate_watdiv_like
    from repro_torch.rdf.sharding import ShardedTripleStore

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    libs = _build.build()
    for lib in libs:
        _build.library(lib)
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    if _build.build_log():
        log(_build.build_log().strip())
    gpu = gpu_line()
    hbm = hbm_rate(gpu)
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}")

    rows = []
    if not args.lm_only:
        n_edge = check_edge_cases(dev)
        log(f"edge cases: {n_edge} exact")

        t0 = time.perf_counter()
        gen = generate_watdiv_like(scale=args.scale, seed=0)
        log(f"data: scale {args.scale}, {gen.store.num_triples} triples, "
            f"{gen.dictionary.num_entities} entities in "
            f"{time.perf_counter() - t0:.1f} s")
        full = run_phase("full", gen, gen.store, args.queries,
                         args.max_rows, dev)

        rows += kernel_phase(gen.store, gen.dictionary, full["backend"],
                             full, hbm)

        t0 = time.perf_counter()
        small = generate_watdiv_like(scale=args.sharded_scale, seed=0)
        sharded = ShardedTripleStore.from_store(small.store, 4)
        log(f"data: scale {args.sharded_scale}, 4 shards "
            f"{[sh.num_triples for sh in sharded.shards]} in "
            f"{time.perf_counter() - t0:.1f} s")
        run_phase("sharded", small, sharded, args.queries,
                  args.sharded_max_rows, dev)
        del gen, small, sharded, full
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows += lm_phase(args, hbm, dev)
    log(f"lm phase {time.perf_counter() - t0:.1f} s")

    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
