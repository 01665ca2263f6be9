#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --lm-only --prefill-seq 4096 --decode-cache 4096
                                     # LM and MoE phases alone, short
                                     # (kernel edits)
    python3 chip_smoke.py --sparse-only
                                     # recsys and GNN phases alone
    python3 chip_smoke.py --train-only
                                     # the training phase alone

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
   (bf16 on the tensor cores, float32 on the CUDA cores) and
   ``decode_attention`` (bf16 through a TMA ring, float32 on the CUDA
   cores) held against their plain versions (qwen3, gemma2, granite-moe
   and phi3.5-moe head shapes, ragged lengths, GQA groups of 1 to 16, the
   bf16 kernels' tile and chunk edges, strided and copied operands, a
   cancellation case whose single-rounding control must fail) and timed
   beside their bounds at the serving shapes, decode also at gemma2-2b's.
6. MoE LM serving (also under ``--lm-only``), granite-moe-1b at full width
   and depth (weights from ``--seed``): float32 prefill and decode on the
   card against the CPU, whose controls (TF32; each token's K-th expert
   left out of the combine) must fail, with the expert choices of both
   sides compared; one layer's routing with drops (capacity factor 0.5,
   dyadic inputs, so the router logits and their ties are exact) on the
   card against the CPU, ids, keep mask and kept count equal, and a
   planted off-by-one capacity that must fail; a bf16 prefill of 32,768
   tokens and 64 decode steps of 32 sequences against a 32,768-position
   cache, with launch counts, no operand copy and decode against prefill;
   ``decode_attention`` timed at its decode shape. Then phi3.5-moe at full
   width and 24 of its 32 layers: a prefill of 4,096 tokens and 16 decode
   steps of 8 sequences against a 4,096-position cache, the same checks.
   After each model, ``flash_attention`` at its prefill shape against the
   plain version, timed.
7. ``segment_sum_sorted`` and ``embedding_bag`` held against their plain
   versions on edge cases (integer-valued inputs exactly, normal ones
   within a summation bound), then Wide&Deep at full width (weights from
   ``--seed``): float32 logits, scores and top-100 on the card against the
   CPU at B = 512; ``serve_p99`` (B = 512), ``serve_bulk`` (B = 262,144)
   and ``retrieval_cand`` (1M candidates) timed; ``embedding_bag`` at the
   bulk shape against its plain version and timed beside its bound.
8. GNNs at full width (weights from ``--seed``): GCN and PNA float32
   logits on the card against the CPU at full_graph_sm (``cora_like``,
   2,708 nodes, d_feat 1,433), EGNN (h, coordinates, energies) and NequIP
   (l0, l1, l2, energies) at the molecule shape (``molecule_batch(128, 30,
   64)``), EGNN and NequIP also under a random rotation; a graph of
   ogb_products' size (2,449,029 nodes, ~61.8M edges, d_feat 100, species
   and coordinates) drawn and sorted on the card, each model's forward
   timed and profiled (PNA, EGNN and NequIP chunk by chunk, launches
   checked against the chunk plan), EGNN and NequIP also at the molecule
   shape; ``segment_sum_sorted`` at each width the forwards launch (GCN's
   16, 7 and the degrees' 1 at the whole graph, PNA's 75, EGNN's 64 and 3
   and NequIP's 64, 288 and 576 at a chunk) against its plain version and
   timed beside its bound. Every model and kernel check also reads a
   planted fault that must fail it.
9. The paper's system, last: ``EdgeCloudSystem`` on the scale-1000 store
   (20 users, 4 edges, B&B and the four baselines, each round cold and
   warm; thread overlap; a query split across two edges), then the SPARQL
   UPDATE write path and an asynchronous rebalance on the 4-shard store;
   every round's results held against the numpy endpoint, bnb's
   objective the lowest, the query kernels launched against the edges'
   stores.
10. The serving front end on the same two systems: the ``qad_solve``
   kernel (R-QAD, behind B&B) against its plain version on the cold bnb
   round's frontiers and seeded instances, both of its routes (the
   register route; the generic route at K = 18); B&B with the R-QAD and the
   marginal bounds on that round's instance; a bnb round on the R-QAD
   bound; HTTP in pool mode (two replicas and the cloud, 32 clients) and
   in round mode (B&B on R-QAD every window, 16 clients); a window of
   reads and two coalesced INSERT DATA on the ingest system; a sampled
   workload replayed through the admission queue, every answer verified.
11. Training (also alone under ``--train-only``): ``flash_attention_bwd``
   (from the forward kernels' new row log-sum-exp) against autograd of
   the plain version, element by element, and ``embedding_bag_bwd``
   against ``zeros`` + ``index_add_`` on edge cases, each with a planted
   fault; one f32
   ``lm_loss`` step of qwen3-0.6b at 2 layers of full width on the card
   against the CPU (TF32 control); a checkpoint of that model and its
   AdamW state saved and restored on the card (a stale step as the
   control); qwen3-0.6b at full width and depth (bf16, B = 8, S = 2,048)
   and Wide&Deep at full width (B = 65,536) taking 5 AdamW steps each on
   one batch, the loss finite and falling, step ms, tokens or samples/s,
   peak memory and launches a step; both backward kernels at those shapes
   against their plain versions, timed beside their bounds and the
   library's (SDPA's backward, ``index_add_``).

Fails (non-zero exit, no result line) on any mismatch or exception, and
when CUDA is not available. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
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
# the query kernels' device kernels (the sample's gather runs before both
# searches), whose time the steady cold batch's profile reports
QUERY_KERNELS = ("triple_scan_kernel", "triple_scan_many_kernel",
                 "probe_sorted_kernel", "scan_probe_kernel",
                 "gather_sample_kernel")
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
# the kernel each row times: bf16 at the serving shapes
ATTN_SOURCE = {"flash_attention": "src/repro_torch/csrc/flash_tc.cu",
               "decode_attention": "src/repro_torch/csrc/decode_tc.cu"}
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
# The bf16 flash_attention route alone (csrc/flash_tc.cu) runs P V on the
# tensor cores with P split in two bf16 parts, p_hi = bf16(p) and p_lo =
# bf16(p - p_hi): p_hi + p_lo is within 2^-16 p, so the output is within
# 2^-16 A of a float32 product, A = sum p|v| / l (the plain version on
# |v|); the factor 2 covers the one reordering of the two partial sums. Its
# check adds SPLIT_GROWTH * A to ATTN_TOL's bound; one rounding of P would
# need 2^-8 A, 2^7 times more, which the cancellation case's control shows.
SPLIT_GROWTH = 2.0 ** -15
# f32 card-vs-CPU logits and bf16 decode-vs-prefill logits, relative to
# max(1, max |logit|); each run also reads a control (TF32 matmuls; the
# current token left out of decode attention) that must exceed its limit
MODEL_TOL = 2e-5
CONSISTENCY_TOL = 0.05
PLANTED_DROP = 64            # keys a planted attention fault leaves out
MOE_ARCH = "granite-moe-1b-a400m"
MOE_SECOND_ARCH = "phi3.5-moe-42b-a6.6b"
# granite serves decode_32k at batch 128 -> 32 (128 caches are 206 GB);
# phi3.5-moe at 24 of its 32 layers (its 41.9B parameters are 83.7 GB in
# bf16, more than the card's 80; 24 layers are 62.9 GB, and a layer more
# takes 2.6 GB), prefill 4,096 tokens and 16 decode steps of 8 sequences
# against a 4,096-position cache
MOE_DECODE_BATCH = 32
MOE_SECOND_LAYERS = 24
MOE_SECOND_SEQ = 4096
MOE_SECOND_BATCH = 8
MOE_SECOND_STEPS = 16
# the routing check with drops: 4 groups of 1,024 tokens, capacity 0.5
MOE_DROP_GROUPS = 4
MOE_DROP_TOKENS = 1024
MOE_DROP_FACTOR = 0.5
# decode against prefill on a 16-token prompt (positions 8 to 15 decoded):
# the off-by-one control leaves out 1 of n keys, and at the dense check's
# n = 33 to 64 that moves granite's random-weight logits less than the
# limit, so the check could not see it there
MOE_CONSISTENCY_PROMPT = 16
SPARSE_SOURCE = "src/repro_torch/csrc/sparse_kernels.cu"
SPARSE_REPLACES = {
    "segment_sum_sorted": "src/repro/kernels/segment_mp.py:107",
    "embedding_bag": "src/repro/kernels/embedding_bag.py:70",
}
RECSYS_ARCH = "wide-deep"
GNN_ARCH = "gcn-cora"
GNN_ZOO = ("pna", "egnn", "nequip")
# timed calls of each forward at ogb_products' size, beyond the warm-up, the
# counted, the profiled and the width-tallied ones: PNA's takes 3.2 s and
# NequIP's 7.8 s on an H100, so they are timed once
GNN_CALLS = {"gcn": 5, "pna": 1, "egnn": 2, "nequip": 1}
# The sparse kernels' sums against their plain versions, per element:
# |kernel - plain| <= SUM_GROWTH * n * A + rtol * |plain|, with n the number
# of terms and A the sum of their magnitudes (over the bag's count for
# mean). Two float32 sums of the same n terms in any order differ by at most
# 2 (n - 1) 2^-24 A; mean's division rounds once on each side (2^-23 of the
# result, rtol 2^-22 leaves a factor 2); bfloat16 adds one unit in the last
# place of the rounded sum (2^-7). On integer-valued inputs whose sums stay
# under 2^24 every order is exact, and the check is equality.
SUM_GROWTH = 2.0 ** -23
SUM_RTOL = {"float32": 2.0 ** -22, "bfloat16": 2.0 ** -7}
SEGMENT_CUT = 256            # a planted segment fault's edge boundary
# f32 card-vs-CPU Wide&Deep logits and GCN logits, relative to max(1, max
# |logit|): their sums are short (MLP rows of 1,293, GCN rows of 1,433 with
# ~17 non-zeros), so both sides agree to about 1e-7, and TF32 matmuls (a
# control each run must exceed) move them by about 4e-5 (a CPU emulation
# of TF32 rounding at full width)
SPARSE_MODEL_TOL = 2e-6
# EGNN and NequIP at x and at R x, relative to max(1, max |output|): R x
# rounds the coordinates (2^-24 relative), which the layers carry through;
# on the CPU the worst output (EGNN's energies) moved 1.5e-6, and the planted
# permutation of the edge vectors' components moves them by 0.17-0.41
ROTATION_TOL = 2e-5


# profiling sessions kernel_device_ms runs before it gives up
PROFILE_TRIES = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _columns(table) -> np.ndarray:
    """The bindings with their columns in variable-name order."""
    order = sorted(table.var_names)
    return table.bindings[:, [table.var_names.index(v) for v in order]]


def sorted_rows(table) -> np.ndarray:
    """Solution multiset as rows sorted lexicographically, columns in
    variable-name order."""
    rows = _columns(table)
    if len(rows) == 0 or rows.shape[1] == 0:       # ASK: rows alone count
        return rows
    return rows[np.lexsort(rows.T[::-1])]


def same_answer(a, b) -> bool:
    """Equal solution multisets. Where every row's ids fit one int64 (ids
    offset to start at 0, a field of ``bits`` bits a column), the rows are
    packed into such keys, an injective map, and the sorted keys compared;
    otherwise the rows are sorted lexicographically. Both are exact."""
    if sorted(a.var_names) != sorted(b.var_names):
        return False
    ra, rb = _columns(a), _columns(b)
    if ra.shape != rb.shape:
        return False
    if ra.size == 0:
        return True
    lo = min(int(ra.min()), int(rb.min()))
    bits = max(int(ra.max()), int(rb.max())) - lo
    bits = max(1, bits.bit_length())
    if bits * ra.shape[1] > 63:
        return np.array_equal(sorted_rows(a), sorted_rows(b))

    def keys(rows):
        k = np.zeros(len(rows), dtype=np.int64)
        for c in range(rows.shape[1]):
            k = (k << bits) | (rows[:, c].astype(np.int64) - lo)
        k.sort()
        return k
    return np.array_equal(keys(ra), keys(rb))


def query_mix(gen, n_queries: int, seed: int) -> list[str]:
    from repro_torch.rdf.generator import workload_sparql
    return workload_sparql(gen, n_queries, seed=seed,
                           templates=MIX_TEMPLATES) + [SINGLE_PATTERN]


class ProbeLaunches:
    """Records the (K, n) of every ``probe_sorted_many`` call while active
    (the join kernel of the device route), and keeps the keys and probes
    of the one with the most probes."""

    def __init__(self):
        self.shapes: list[list[int]] = []
        self.largest = None

    def __enter__(self):
        from repro_torch.kernels import join_probe
        self._module, self._kernel = join_probe, join_probe.probe_sorted_many

        def record(keys, probes):
            self.shapes.append([int(keys.shape[0]), int(probes.numel())])
            if self.largest is None or \
                    probes.numel() > self.largest[1].numel():
                self.largest = (keys, probes)
            return self._kernel(keys, probes)

        join_probe.probe_sorted_many = record
        return self

    def __exit__(self, *exc):
        self._module.probe_sorted_many = self._kernel


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
    with ProbeLaunches() as probes:
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
    profile = (device_profile(lambda: _steady_cold(ep, texts),
                              track=QUERY_KERNELS)
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
        "launches": launches, "probe_launches_cold": probes.shapes,
        "backend": backend, "probe_largest": probes.largest,
    }


def device_profile(fn, track: tuple[str, ...] = (),
                   cpu: bool = True) -> dict:
    """Device time of one ``fn()`` under ``torch.profiler``: the sum over
    kernels and copies, its share of the call's wall time (which the
    profiler itself inflates), the largest items, and [ms, launches] of
    the kernels whose names contain a string of ``track``. ``cpu=False``
    traces the device alone (a long host-bound call's CPU trace would
    hold millions of events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=([ProfilerActivity.CPU] if cpu else [])
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    items = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                    for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")), reverse=True)
    device_ms = sum(ms for ms, _, _ in items)
    tracked = {t: [sum(ms for ms, key, _ in items if t in key),
                   sum(n for _, key, n in items if t in key)]
               for t in track}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [[key[:60], ms, n] for ms, key, n in items[:8]],
            "tracked": tracked}


def kernel_device_ms(fn, kernel: str, calls: int = 20) -> tuple[float, int]:
    """Device time of one launch of ``kernel`` (a substring of its name)
    under ``torch.profiler`` over ``calls`` calls of ``fn``: the mean over
    the launches the profiler recorded, and their number. The kernel's own
    time, where back-to-back CUDA events read the host's time per call
    once that exceeds the kernel's; the profiler can drop records, so the
    mean is taken over those it kept, not over ``calls``. It has dropped
    a whole session's records of one kernel on the card now and then, so
    a session that kept none is run again, up to ``PROFILE_TRIES`` in
    all, before this raises; each such retry is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for session in range(1, PROFILE_TRIES + 1):
        if session > 1:
            log(f"profiler retry: session {session - 1} of "
                f"{PROFILE_TRIES} recorded no {kernel} launch")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel in e.key
                and str(e.device_type).endswith("CUDA")]
        n = sum(e.count for e in hits)
        if n:
            return sum(e.self_device_time_total for e in hits) / n / 1e3, n
    raise AssertionError(f"the profiler recorded no {kernel} launch in "
                         f"{PROFILE_TRIES} sessions")


def host_us_per_call(fn, calls: int = 50) -> float:
    """Host time to enqueue one ``fn()`` (no synchronise inside the
    timed loop), in microseconds: the wrapper's share of a host-bound
    step."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _steady_cold(ep, texts: list[str]) -> None:
    ep.clear_cache()
    ep.query_many(texts)


# ---------------------------------------------------------------------------
# kernel phase (card only)
# ---------------------------------------------------------------------------


def time_ms(fn, calls: int = 5, reps: int = 7) -> float:
    """Median over ``reps`` of the mean time of ``calls`` back-to-back
    calls, between CUDA events, after a warm-up. The first call's host time
    falls inside the events, so a short kernel takes more calls."""
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
    from repro_torch.kernels.join_probe import (SAMPLE_MAX, SAMPLE_MIN,
                                                probe_plan, probe_sorted_many,
                                                scan_probe)
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
    # the two-level search: K around and past the shared-memory sample,
    # runs of 1-8 equal keys and one of 3 strides across its boundaries,
    # all keys equal; T off the 4-row step; triples 12 bytes off 16 (a
    # view one row in) and keys 4 bytes off (scalar loads); -1, INT32_MIN
    # and INT32_MAX probes
    S = SAMPLE_MAX
    extremes = np.asarray([-1, -2 ** 31, 2 ** 31 - 1], np.int32)
    for K in (S - 1, S, S + 1, 3 * S + 5, 10 * S + 3, 2 * S + 1):
        if K == 2 * S + 1:
            k_np = np.full(K, 7, np.int64)
        else:
            k_np = 3 * np.repeat(np.arange(K), rng.integers(1, 9, K))[:K]
            stride = -(-K // S)
            k_np[K // 2:K // 2 + 3 * stride] = k_np[K // 2]
        keys = t32(np.concatenate([k_np[:1], k_np]))
        for T in (1, 3, 5, 100_003):
            vals = rng.integers(-2, 3 * K + 3, (T + 1, 3))
            vals[:, [0, 2]] = np.where(rng.random((T + 1, 2)) < 0.05,
                                       rng.choice(extremes, (T + 1, 2)),
                                       vals[:, [0, 2]])
            rows = t32(vals)
            for tri, k in ((rows[:T], keys[:K]), (rows[1:], keys[1:])):
                assert tri.is_contiguous() and k.is_contiguous()
                for col in (0, 2):
                    pat = (-1, int(vals[0, 1]), -1)
                    if max_abs_err(scan_probe(tri, pat, k, col),
                                   ref.scan_probe_reference(tri, *pat, k,
                                                            col)):
                        raise AssertionError(
                            f"scan_probe differs at K={K} T={T} col={col} "
                            f"offsets {tri.data_ptr() % 16} "
                            f"{k.data_ptr() % 16}")
                    cases += 1
    # probe_sorted_many on the two-level search: n off a multiple of 4 (a
    # scalar last quad), probes 4 to 12 bytes off 16 (a view 1-3 elements
    # in: scalar loads), n small enough to shrink the sample and large
    # enough for the full one, K around SAMPLE_MIN and past SAMPLE_MAX with
    # runs of equal keys, [Q, P] shapes, -1 padding and the int32 extremes
    for K in (SAMPLE_MIN - 1, SAMPLE_MIN + 1, 3 * S + 5, 10 * S + 3):
        k_np = np.sort(3 * rng.integers(0, K, K))
        k_np[K // 3:K // 3 + 200] = k_np[K // 3]
        keys = t32(k_np)
        for n in (1, 2, 3, 5, 257, 4099, 200_003):
            vals = rng.integers(-2, 3 * K + 3, n + 3)
            vals = np.where(rng.random(n + 3) < 0.1,
                            rng.choice(extremes, n + 3), vals)
            flat = t32(vals)
            for off in range(4):
                shape = (3, n // 3) if off == 0 and n % 3 == 0 else (1, n)
                probes = flat[off:off + n].view(shape)
                if max_abs_err(probe_sorted_many(keys, probes),
                               ref.probe_sorted_reference(keys, probes)):
                    raise AssertionError(
                        f"probe_sorted_many differs at K={K} n={n} "
                        f"offset {probes.data_ptr() % 16} "
                        f"{probe_plan(n, K, probes.data_ptr() % 16 == 0)}")
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
    from repro_torch.kernels.join_probe import (probe_plan, probe_sorted_many,
                                                scan_probe)
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
    # the cold batch's probe_sorted_many launch with the most probes
    ckeys, cprobes = serving["probe_largest"]
    cK, cP = ckeys.shape[0], cprobes.numel()
    csteps = math.ceil(math.log2(cK + 1))

    pplan = probe_plan(P, K, probes.data_ptr() % 16 == 0)
    cplan = probe_plan(cP, cK, cprobes.data_ptr() % 16 == 0)
    splan = probe_plan(T, K, triples.data_ptr() % 16 == 0)

    def searches(kernel, plan):
        """The search kernel, and the sample's gather where the plan
        samples the keys."""
        return (kernel,) + (("gather_sample_kernel",) if plan.stride > 1
                            else ())

    specs = [
        ("triple_scan", lambda: triple_scan(triples, scan_pat),
         lambda: ref.triple_scan_reference(triples, *scan_pat), None,
         16 * T, 3 * T, f"T={T}", ("triple_scan_kernel",)),
        ("triple_scan_many", lambda: triple_scan_many(triples, pats),
         lambda: ref.triple_scan_many_reference(triples, pats), None,
         12 * T + 12 * Q + 4 * Q * T, 3 * Q * T, f"T={T} Q={Q}",
         ("triple_scan_many_kernel",)),
        ("probe_sorted_many", lambda: probe_sorted_many(keys, probes),
         lambda: ref.probe_sorted_reference(keys, probes),
         lambda: (torch.searchsorted(keys, probes, out_int32=True),
                  torch.searchsorted(keys, probes, right=True,
                                     out_int32=True)),
         4 * K + 12 * P, 2 * P * steps, f"K={K} P={P} {pplan}",
         searches("probe_sorted_kernel", pplan)),
        ("probe_sorted_many", lambda: probe_sorted_many(ckeys, cprobes),
         lambda: ref.probe_sorted_reference(ckeys, cprobes),
         lambda: (torch.searchsorted(ckeys, cprobes, out_int32=True),
                  torch.searchsorted(ckeys, cprobes, right=True,
                                     out_int32=True)),
         4 * cK + 12 * cP, 2 * cP * csteps,
         f"K={cK} P={cP}, the cold batch's largest {cplan}",
         searches("probe_sorted_kernel", cplan)),
        ("scan_probe", lambda: scan_probe(triples, probe_pat, keys, 2),
         lambda: ref.scan_probe_reference(triples, *probe_pat, keys, 2),
         None, 24 * T + 4 * K, 3 * T + 2 * T * steps,
         f"T={T} K={K} {splan}", searches("scan_probe_kernel", splan)),
    ]
    rows = []
    for name, kern, plain, lib, nbytes, ops, shape, kernels in specs:
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
            # the profiler's: events over back-to-back calls read the
            # host's time a call where it exceeds the card's
            "device_ms": sum(kernel_device_ms(kern, k)[0] for k in kernels),
            "shape": shape,
        }
        rows.append(row)
        log(f"kernel {name} [{shape}]: kernel_ms={row['ms']} "
            f"device_ms={row['device_ms']} "
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
    if isinstance(tree, (list, tuple)):
        return type(tree)(_params_to(v, device) for v in tree)
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


@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` replaced by ``fn`` (given the original) inside the
    block: a planted fault or a recorder around one model function."""
    old = getattr(module, name)
    setattr(module, name, fn(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def route_capture(calls: list):
    """A wrapper of ``transformer._moe_route`` that appends each call's
    ``MoeRoute`` to ``calls``."""
    def wrap(route):
        def captured(*args):
            calls.append(route(*args))
            return calls[-1]
        return captured
    return wrap


def drop_kth_expert(route):
    """Planted routing fault: each token's K-th (smallest) expert left out
    of the combine."""
    def faulty(cfg, router, x, e0, El):
        r = route(cfg, router, x, e0, El)
        w = r.weights.clone()
        w[..., -1] = 0
        return r._replace(weights=w)
    return faulty


def topk_gap(route):
    """Each token's gap between its K-th and (K+1)-th router
    probabilities [G, Tg] on the host: the smallest change of the float32
    router sums that could pick another expert."""
    import torch
    K = route.ids.shape[-1]
    top = torch.topk(route.probs, K + 1, dim=-1).values
    return (top[..., K - 1] - top[..., K]).cpu()


def routing_flips(got: list, want: list) -> dict:
    """Expert choices of two runs of the same calls (``route_capture``)
    compared: the smallest K-th vs (K+1)-th gap of the reference run, and
    the calls whose ids differ with the smallest gap among their flipped
    tokens."""
    import torch
    flips = []
    for a, b in zip(got, want):
        differ = (a.ids.cpu() != b.ids.cpu()).any(dim=-1)
        if differ.any():
            flips.append(float(topk_gap(b)[differ].min()))
    return {"route_calls": len(want),
            "min_topk_gap": min(float(topk_gap(r).min()) for r in want),
            "flipped_calls": len(flips), "flip_gaps": flips[:8]}


def lm_model_check(cfg, seed: int, device, prompt: int = 128,
                   steps: int = 16, ref_device="cpu") -> dict:
    """Float32 weights from ``seed``: a prefill of ``prompt`` tokens and
    ``steps`` decode steps from an empty cache on ``device`` (through the
    kernels on a card), then the same weights and tokens on ``ref_device``
    (the plain versions on the CPU). ok when every logit is finite and
    max |diff| <= MODEL_TOL * max(1, max |logit|). On a card the control
    runs the card side again with TF32 matmuls; ok also needs its diff
    above the limit, or the check could not see such a fault. An MoE
    config adds a second control on any device, each token's K-th expert
    left out of the combine (``drop_kth_expert``), and records the expert
    choices of both sides (``routing_flips``)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.transformer import (init_kv_cache, init_lm_params,
                                                lm_decode_step, lm_prefill)
    dev = torch.device(device)
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), torch.float32, dev)
    tokens = _tokens(seed, (1, prompt), cfg.vocab, "cpu")

    def run(p, d, routes=None):
        with (patched(transformer, "_moe_route", route_capture(routes))
              if routes is not None else contextlib.nullcontext()):
            pre = lm_prefill(cfg, p, tokens.to(d))
            cache = init_kv_cache(cfg, 1, steps, torch.float32, d)
            dec = [lm_decode_step(cfg, p, cache, tokens[:, t:t + 1].to(d),
                                  t)[0] for t in range(steps)]
        return pre.cpu(), torch.cat(dec, dim=1).cpu()

    def diff(got):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    routes_got, routes_want = ([], []) if cfg.moe else (None, None)
    got = run(params, dev, routes_got)
    ref_dev = torch.device(ref_device)
    want = run(_params_to(params, ref_dev), ref_dev, routes_want)
    scale = max(float(w.abs().max()) for w in want)
    limit = MODEL_TOL * max(1.0, scale)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    control = routing = None
    if dev.type == "cuda":
        matmul = torch.backends.cuda.matmul
        tf32, matmul.allow_tf32 = matmul.allow_tf32, True
        try:
            control = diff(run(params, dev))
        finally:
            matmul.allow_tf32 = tf32
    out = {"prompt": prompt, "steps": steps, "max_abs_diff": diff(got),
           "max_abs_logit": scale, "limit": limit,
           "tf32_control_diff": control}
    if cfg.moe:
        with patched(transformer, "_moe_route", drop_kth_expert):
            routing = diff(run(params, dev))
        out["routing_control_diff"] = routing
        out.update(routing_flips(routes_got, routes_want))
    out["ok"] = (finite and diff(got) <= limit
                 and (control is None or control > limit)
                 and (routing is None or routing > limit))
    return out


def kept_recount(ids, E: int, C: int) -> int:
    """Kept assignments recomputed in numpy from the expert ids [G, Tg, K]:
    per group and expert, at most C (the first C in token order)."""
    ids = ids.cpu().numpy().reshape(ids.shape[0], -1)
    return sum(int(np.minimum(np.bincount(g, minlength=E), C).sum())
               for g in ids)


def moe_drop_check(cfg, seed: int, device, ref_device="cpu",
                   groups: int = MOE_DROP_GROUPS,
                   tokens: int = MOE_DROP_TOKENS,
                   planted: bool = False) -> dict:
    """``_moe_core`` of one layer at ``cfg``'s width on ``groups`` groups of
    ``tokens`` tokens with capacity factor ``MOE_DROP_FACTOR`` (so that
    assignments drop), in float32 on ``device`` and on ``ref_device``.
    x and the router are small dyadic values (integers in [-2, 2] over 4
    and over 8), so the router logits are exact on both devices and equal
    logits tie exactly on both; the experts' weights are normal draws. ok
    when the expert ids, the keep mask and the kept count are equal on
    both sides, the kept count equals ``kept_recount`` of the ids, some
    assignments drop, and y is within MODEL_TOL * max(1, max |y|).
    ``planted`` runs the ``device`` side with the capacity off by one."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.common import dense_init
    cfg = dataclasses.replace(cfg, capacity_factor=MOE_DROP_FACTOR)
    E, D, F, K = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k
    g = torch.Generator().manual_seed(seed + 5)
    x = torch.randint(-2, 3, (groups, tokens, D), generator=g).float() / 4
    router = torch.randint(-2, 3, (D, E), generator=g).float() / 8
    experts = [dense_init(g, shape, dtype=torch.float32)
               for shape in ((E, D, F), (E, D, F), (E, F, D))]

    def run(d, capacity_fault=False):
        routes = []
        with (patched(transformer, "moe_capacity",
                      lambda cap: lambda c, tg: cap(c, tg) + 1)
              if capacity_fault else contextlib.nullcontext()), \
                patched(transformer, "_moe_route", route_capture(routes)):
            y, aux = transformer._moe_core(
                cfg, *(t.to(d) for t in (router, *experts, x)))
        return routes[0], y.cpu(), float(aux)

    r_got, y_got, aux_got = run(torch.device(device), planted)
    r_want, y_want, aux_want = run(torch.device(ref_device))
    scale = float(y_want.abs().max())
    limit = MODEL_TOL * max(1.0, scale)
    kept = int(r_got.keep.sum())
    kept_want = int(r_want.keep.sum())
    recount = kept_recount(r_want.ids, E, r_want.capacity)
    top = torch.sort(r_want.probs, dim=-1, descending=True).values
    out = {"groups": groups, "tokens": tokens, "capacity": r_got.capacity,
           "assignments": groups * tokens * K, "kept": kept,
           "kept_ref": kept_want, "kept_recount": recount,
           "tied_kth": int((top[..., K - 1] == top[..., K]).sum()),
           "ids_equal": torch.equal(r_got.ids.cpu(), r_want.ids.cpu()),
           "keep_equal": torch.equal(r_got.keep.cpu(), r_want.keep.cpu()),
           "max_abs_diff": float((y_got - y_want).abs().max()),
           "max_abs_y": scale, "limit": limit,
           "aux_diff": abs(aux_got - aux_want)}
    out["ok"] = (out["ids_equal"] and out["keep_equal"]
                 and kept == kept_want == recount
                 and recount < out["assignments"]
                 and out["max_abs_diff"] <= limit)
    return out


def lm_prefill_phase(cfg, params, seq: int, batch: int, warm_seq: int,
                     seed: int, device, profile: bool = False,
                     track: tuple[str, ...] = ()) -> dict:
    """One untimed prefill of ``warm_seq`` tokens, then one timed prefill
    of [batch, seq] tokens; the launch counts are set to 0 just before the
    timed pass and read just after. ``profile`` adds a profiled pass
    (``track``: kernel-name parts whose time it adds up)."""
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
                                                           tokens), track)
    return out


def lm_decode_phase(cfg, params, batch: int, cache_len: int, steps: int,
                    seed: int, device, profile: int = 0,
                    track: tuple[str, ...] = ()) -> dict:
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
        out["profile"] = device_profile(again, track)
        out["profile"]["steps"] = profile
        out["profile"]["device_ms_per_step"] = (out["profile"]["device_ms"]
                                                / profile)
    return out


def layer_cursor(L: int):
    """For the MoE calls of one pass in order (a prefill, then decode
    steps: layers 0 to L - 1 in turn), ``next(Tg)`` gives the call's layer
    and the first position of its Tg tokens."""
    calls, start = [0], [0] * L

    def next_call(Tg: int) -> tuple[int, int]:
        layer = calls[0] % L
        calls[0] += 1
        start[layer] += Tg
        return layer, start[layer] - Tg
    return next_call


def forced_topk(ids: list, L: int):
    """A wrapper of ``transformer._moe_topk`` that makes each call choose
    the experts ``ids[layer]`` [G, S, K] chose at the call's positions (a
    prefill's choices), with their probabilities renormalized as weights."""
    cursor = layer_cursor(L)

    def wrap(topk):
        def forced(cfg, router, x):
            probs, _, _, aux = topk(cfg, router, x)
            layer, pos = cursor(x.shape[1])
            chosen = ids[layer][:, pos:pos + x.shape[1]]
            w = probs.gather(-1, chosen)
            return probs, chosen, w / w.sum(dim=-1, keepdim=True), aux
        return forced
    return wrap


def lm_consistency(cfg, params, prompt: int, seed: int, device) -> dict:
    """Decode against prefill on one prompt: prefill its first half into a
    cache, decode the second half token by token, and compare those
    logits with a prefill of the whole prompt. The control decodes again
    with a planted off-by-one: each step's attention leaves out the
    current token (valid lengths ``pos`` instead of ``pos + 1``).

    An MoE config decodes with the whole prompt's expert choices
    (``forced_topk``): in bf16 the two attention routes round apart, and
    where a token's K-th and (K+1)-th router probabilities lie that close
    it takes another expert, a difference of routing and not of the cache.
    The free decode's diff and its expert choices that differ from the
    prefill's are recorded beside it."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.transformer import (init_kv_cache,
                                                lm_decode_step, lm_prefill)
    tokens = _tokens(seed + 4, (1, prompt), cfg.vocab, device)
    half, L = prompt // 2, cfg.n_layers
    routes = []
    with (patched(transformer, "_moe_route", route_capture(routes))
          if cfg.moe else contextlib.nullcontext()):
        want = lm_prefill(cfg, params, tokens)[:, half:].float()
    ids = [r.ids for r in routes]

    def decode(force: bool, free_routes=None):
        with (patched(transformer, "_moe_topk", forced_topk(ids, L))
              if force else contextlib.nullcontext()), \
                (patched(transformer, "_moe_route",
                         route_capture(free_routes))
                 if free_routes is not None else contextlib.nullcontext()):
            cache = init_kv_cache(cfg, 1, prompt, params["embed"].dtype,
                                  device)
            lm_prefill(cfg, params, tokens[:, :half], cache)
            return torch.cat([lm_decode_step(cfg, params, cache,
                                             tokens[:, t:t + 1], t)[0]
                              for t in range(half, prompt)], dim=1).float()

    got = decode(cfg.moe)
    with patched(transformer, "decode_attention",
                 lambda kernel: lambda q, k, v, lengths, **kw: kernel(
                     q, k, v, lengths - 1, **kw)):
        planted = decode(cfg.moe)
    out = {"prompt": prompt, "decoded": prompt - half,
           "max_abs_diff": float((got - want).abs().max()),
           "max_abs_logit": float(want.abs().max()),
           "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                 .float().mean()),
           "off_by_one_control_diff": float((planted - want).abs().max())}
    if cfg.moe:
        free_routes = []
        free = decode(False, free_routes)
        cursor, flips = layer_cursor(L), 0
        for r in free_routes:
            layer, pos = cursor(r.ids.shape[1])
            flips += int((r.ids != ids[layer][:, pos:pos + r.ids.shape[1]])
                         .any(dim=-1).sum())
        out["free_routing_diff"] = float((free - want).abs().max())
        out["free_routing_changed"] = flips
        out["routings"] = L * prompt
    return out


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


def attn_err(got, want, split=None) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (atol + rtol * |want|)) with
    the tolerance of want's dtype: within tolerance when the second is
    at most 1. ``split`` (the plain version on |v|, A = sum p|v| / l per
    element) adds SPLIT_GROWTH * A to the bound: the check of the bf16
    flash route, whose P is split in two bf16 parts."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    if not got.numel():
        return 0.0, 0.0
    atol, rtol = ATTN_TOL[str(want.dtype).removeprefix("torch.")]
    w = want.float()
    delta = (got.float() - w).abs()
    bound = atol + rtol * w.abs()
    if split is not None:
        bound = bound + SPLIT_GROWTH * split.float().abs()
    return float(delta.max()), float((delta / bound).max())


def split_bound(q, k, v, window: int = 0, softcap: float = 0.0):
    """A = sum p|v| / l per output element (the plain version on |v|) for
    the bf16 flash route's check; None for float32, whose route does not
    split P."""
    import torch
    from repro_torch.kernels import ref
    if q.dtype != torch.bfloat16:
        return None
    return ref.mha_reference(q, k, v.abs(), True, window, softcap)


def p_rounded_once(q, k, v, window: int = 0, softcap: float = 0.0):
    """The plain version with P rounded once to bf16 before P V (the sum l
    over the unrounded p), as FA2, FA3 and SDPA compute it: the control
    the bf16 flash check must tell from the split. Dense; small S."""
    import torch
    B, H, S, d = q.shape
    G = H // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d ** -0.5
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf)
    return (o / l).to(q.dtype)


def paired_values(gen, B, Hkv, S, d, dtype, dev):
    """[B, Hkv, S, d] with rows in pairs of opposite sign (row 2i + 1 =
    -row 2i): outputs near 0, where the terms cancel."""
    import torch
    half = torch.randn((B, Hkv, (S + 1) // 2, d), generator=gen, device=dev,
                       dtype=dtype)
    return torch.stack([half, -half], dim=3).flatten(2, 3)[:, :, :S]


def decode_edge_lengths(B, Hkv, S, d) -> list[int]:
    """Valid lengths at the bf16 decode kernel's edges for this shape: a
    tile (TILE[d] keys) and a chunk (``split_plan``) each minus one, exact
    and plus one, then 0 and S."""
    from repro_torch.kernels.decode_attention import TILE, split_plan
    tile, chunk = TILE[d], split_plan(B, Hkv, S, d)[0]
    return [tile - 1, tile, tile + 1, chunk - 1, chunk, chunk + 1, 0, S]


def check_attention_cases(dev, dtypes=("float32", "bfloat16")) -> dict:
    """Both attention kernels against their plain versions on the card:
    ragged S, GQA groups of 1, 2, 4 and 8 (decode also 16), every
    compiled head dim, the served models' head shapes (qwen3, gemma2,
    granite-moe, phi3.5-moe), windows, softcaps, strided and contiguous
    inputs;
    for flash also S at the 128-row query tile's edges, windows of 1 and
    narrower than a key tile, operands TMA cannot read (a q at an odd
    element offset, a k with d stride != 1: the bf16 route copies them)
    and, in bf16, a cancellation case (V rows in pairs of opposite sign)
    whose control, P rounded once to bf16, must fail the check; for decode
    ragged lengths in one batch at the bf16 kernel's tile and chunk edges
    (``decode_edge_lengths``) and 0 (exact zeros), windows that start
    inside a chunk and end inside a tile, q not contiguous, and caches TMA
    cannot read (the bf16 route copies them). The bf16 flash route is held
    to ATTN_TOL plus SPLIT_GROWTH * A, every other route to ATTN_TOL.
    Returns the number of kernel calls and the largest ``attn_err``
    readings by dtype and by route; raises after every case has run if any
    was out of tolerance."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention

    gen = torch.Generator(device=dev).manual_seed(7)
    flash_cases = [  # B, H, Hkv, S, d, window, softcap
        (1, 2, 2, 1, 64, 0, 0.0), (2, 4, 2, 37, 128, 0, 0.0),
        (1, 8, 1, 1000, 32, 0, 30.0), (2, 8, 8, 1000, 16, 100, 0.0),
        (1, 4, 2, 300, 256, 64, 50.0), (1, 16, 2, 130, 128, 0, 0.0),
        (1, 16, 8, 4096, 128, 0, 0.0),          # qwen3 heads
        (1, 8, 4, 8192, 256, 4096, 50.0),       # gemma2 heads, local layer
        (1, 16, 8, 4096, 64, 0, 0.0),           # granite-moe heads
        (1, 32, 8, 4096, 128, 0, 0.0),          # phi3.5-moe heads
        # the tensor-core kernel's edges: S around the 128-row query tile
        # (64 rows at d = 256)
        (1, 2, 1, 127, 128, 0, 0.0), (1, 2, 2, 128, 64, 0, 0.0),
        (2, 4, 2, 129, 128, 0, 0.0), (1, 4, 1, 257, 256, 0, 0.0),
        (1, 4, 4, 1, 256, 0, 0.0), (1, 2, 1, 65, 256, 0, 0.0),
        # windows of 1 and narrower than a key tile (128; 64 at d = 256)
        (1, 4, 2, 300, 128, 1, 0.0), (1, 2, 1, 400, 64, 50, 0.0),
        (1, 2, 2, 300, 256, 33, 0.0),
        # d = 16 and 32 with GQA groups of 1, 2 and 8
        (1, 2, 2, 200, 16, 0, 0.0), (1, 4, 2, 300, 16, 0, 0.0),
        (1, 8, 1, 260, 16, 0, 0.0), (1, 2, 2, 260, 32, 0, 0.0),
        (1, 4, 2, 200, 32, 0, 0.0), (1, 8, 1, 300, 32, 0, 0.0),
        (1, 4, 2, 400, 256, 0, 50.0),           # d = 256 with softcap
    ]
    strided_case = (1, 4, 2, 300, 128, 0, 0.0)  # operands TMA cannot read
    cancel_case = (1, 4, 2, 256, 128, 0, 0.0)   # V rows in +/- pairs
    # B, H, Hkv, S, d, window, softcap: every GQA group of 1 to 16 at
    # every head dim, B = 8 with the lengths of decode_edge_lengths, windows
    # and softcaps in turn (a window of 300 or 100 from length 1100 starts
    # inside a chunk of 256 keys, 128 at d = 256, and ends inside a tile)
    decode_cases = [
        (8, G * (2 if G <= 4 else 1), 2 if G <= 4 else 1, 1100, d,
         (0, 300, 0, 100)[n % 4], (0.0, 0.0, 50.0, 30.0)[n % 4])
        for n, (G, d) in enumerate((G, d) for G in (1, 2, 4, 8, 16)
                                   for d in HEAD_DIMS)]
    decode_cases += [(4, 16, 8, 4096, 128, 0, 0.0),    # qwen3 heads
                     (4, 8, 4, 8192, 256, 4096, 50.0),  # gemma2, local
                     (4, 16, 8, 4096, 64, 0, 0.0),      # granite-moe
                     (4, 32, 8, 4096, 128, 0, 0.0)]     # phi3.5-moe
    decode_strided_case = (8, 4, 2, 600, 64, 0, 0.0)  # caches TMA cannot read
    worst, routes, bad = {}, {}, []
    calls = 0

    def record(label, dtype, route, got, want, split=None):
        err, ratio = attn_err(got, want, split)
        for w in (worst.setdefault(dtype, {"max_abs_err": 0.0,
                                           "max_ratio": 0.0}),
                  routes.setdefault(f"{route} {dtype}",
                                    {"max_abs_err": 0.0, "max_ratio": 0.0})):
            w["max_abs_err"] = max(w["max_abs_err"], err)
            w["max_ratio"] = max(w["max_ratio"], ratio)
        if not ratio <= 1.0:
            bad.append(f"{label}: max |kernel - plain| {err}, {ratio}x the "
                       f"tolerance")

    def flash(label, name, q, k, v, win, cap):
        nonlocal calls
        calls += 1
        want = ref.mha_reference(q, k, v, True, win, cap)
        record(f"flash_attention {name} {label}", name, "flash_attention",
               flash_attention(q, k, v, window=win, softcap=cap), want,
               split_bound(q, k, v, win, cap))
        return want

    for name in dtypes:
        dtype = getattr(torch, name)
        for i, (B, H, Hkv, S, d, win, cap) in enumerate(flash_cases):
            layout = "bshd" if i % 2 == 0 else "bhsd"
            q, k, v = _attn_inputs(gen, B, H, Hkv, S, d, dtype, dev, layout)
            flash(flash_cases[i], name, q, k, v, win, cap)

        B, H, Hkv, S, d, win, cap = strided_case
        _, _, v = _attn_inputs(gen, B, H, Hkv, S, d, dtype, dev, "bhsd")
        q = torch.randn(B * H * S * d + 1, generator=gen, device=dev,
                        dtype=dtype)[1:].view(B, H, S, d)
        k = torch.randn((B, Hkv, d, S), generator=gen, device=dev,
                        dtype=dtype).transpose(2, 3)
        copies = flash_attention.copies
        flash(f"{strided_case} q 1 element off, k d-stride {k.stride(-1)}",
              name, q, k, v, win, cap)
        if name == "bfloat16" and flash_attention.copies != copies + 2:
            bad.append(f"flash_attention {name}: an unaligned q and a k "
                       f"with d stride {k.stride(-1)} made "
                       f"{flash_attention.copies - copies} copies, not 2")

        if name == "bfloat16":
            B, H, Hkv, S, d, win, cap = cancel_case
            q, k, _ = _attn_inputs(gen, B, H, Hkv, S, d, dtype, dev)
            v = paired_values(gen, B, Hkv, S, d, dtype, dev)
            want = flash(f"{cancel_case} cancellation", name, q, k, v, win,
                         cap)
            control_err, control = attn_err(
                p_rounded_once(q, k, v, win, cap), want,
                split_bound(q, k, v, win, cap))
            routes["P rounded once (control)"] = {
                "max_abs_err": control_err, "max_ratio": control}
            if not control > 1.0:
                bad.append(f"flash_attention {name} {cancel_case}: P "
                           f"rounded once is within the check ({control}x)"
                           f": the check cannot tell it from the split")

        def decode(label, q, k, v, lens, win, cap):
            nonlocal calls
            calls += 1
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = decode_attention(q, k, v, lengths, window=win, softcap=cap)
            label = f"decode_attention {name} {label} {lens}"
            record(label, name, "decode_attention", out,
                   ref.decode_reference(q, k, v, lengths, win, cap))
            if 0 in lens and out[lens.index(0)].any():
                bad.append(f"{label}: length 0 gives non-zeros")

        for i, (B, H, Hkv, S, d, win, cap) in enumerate(decode_cases):
            layout = "bshd" if i % 2 == 0 else "bhsd"
            _, k, v = _attn_inputs(gen, B, H, Hkv, S, d, dtype, dev, layout)
            if i % 3 == 0:                      # q with d stride H
                q = torch.randn((B, d, H), generator=gen, device=dev,
                                dtype=dtype).transpose(1, 2)
            else:
                q = torch.randn((B, H, d), generator=gen, device=dev,
                                dtype=dtype)
            lens = (decode_edge_lengths(B, Hkv, S, d) if B == 8
                    else [1, S // 2 + 1, S - 1, S])
            decode(f"{decode_cases[i]} q strides {q.stride()}", q, k, v,
                   lens, win, cap)

        B, H, Hkv, S, d, win, cap = decode_strided_case
        q = torch.randn((B, H, d), generator=gen, device=dev, dtype=dtype)
        k = torch.randn((B, Hkv, d, S), generator=gen, device=dev,
                        dtype=dtype).transpose(2, 3)
        v = torch.randn(B * Hkv * S * d + 1, generator=gen, device=dev,
                        dtype=dtype)[1:].view(B, Hkv, S, d)
        copies = decode_attention.copies
        decode(f"{decode_strided_case} k d-stride {k.stride(-1)}, v 1 "
               f"element off", q, k, v, decode_edge_lengths(B, Hkv, S, d),
               win, cap)
        if name == "bfloat16" and decode_attention.copies != copies + 2:
            bad.append(f"decode_attention {name}: a k with d stride "
                       f"{k.stride(-1)} and an unaligned v made "
                       f"{decode_attention.copies - copies} copies, not 2")
    torch.cuda.synchronize()
    if bad:
        raise AssertionError("; ".join(bad))
    return {"cases": calls, **worst, "routes": routes}


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


def flash_serving_row(cfg, B: int, S: int, launches: dict, hbm: float,
                      gen) -> dict:
    """``flash_attention`` at a model's prefill shape (its heads, B
    sequences of S tokens in the model's strided layout, bf16) against the
    plain version on the same card inputs, with the planted fault of
    ``_attn_row``, timed beside its bound and one PyTorch call; raises if
    the kernel copied an operand. ``launches``: the prefill's counts."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    dev = torch.device("cuda")
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = _attn_inputs(gen, B, H, Hkv, S, d, torch.bfloat16, dev)
    pairs = B * H * S * (S + 1) // 2                  # causal (q, k) pairs
    flops = 4 * d * pairs
    nbytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
    lib, how = _sdpa(q.contiguous(), k.contiguous(), v.contiguous(), True)
    copies = flash_attention.copies
    row = _attn_row(
        "flash_attention", lambda: flash_attention(q, k, v),
        lambda: ref.mha_reference(q, k, v),
        lambda: ref.mha_reference(q, k, v, True, max(1, S - PLANTED_DROP)),
        lib, how, flops, nbytes, hbm, launches,
        f"{cfg.name}: B={B} H={H} Hkv={Hkv} S={S} d={d} bf16", calls=1,
        reps=3, split=lambda: split_bound(q, k, v))
    copies = flash_attention.copies - copies
    log(f"kernel flash_attention at {cfg.name}'s prefill shape: "
        f"{flops / row['ms'] / 1e9} TFLOP/s achieved ({flops} operations "
        f"of the function; the split P runs 1.5x that on the tensor "
        f"cores), {copies} operand copies")
    if copies:
        raise AssertionError(f"flash_attention copied {copies} operands of "
                             f"the serving layout")
    del q, k, v, lib
    torch.cuda.empty_cache()
    return row


def attention_kernel_rows(cfg, prefill: dict, decode: dict,
                          hbm: float) -> list[dict]:
    """Both attention kernels at the serving shapes of the prefill and
    decode phases (bf16, the model's strided layouts), against their plain
    versions on the same card inputs, timed beside their bounds and one
    PyTorch call of the same function; decode also at gemma2-2b's decode
    shape (a log line, not a row)."""
    import torch
    from repro_torch.configs.registry import get_spec
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    dt = torch.bfloat16
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rows = [flash_serving_row(cfg, prefill["batch"], prefill["seq"],
                              prefill["launches"], hbm, gen)]

    B, S = decode["batch"], decode["cache_len"]
    _, k, v = _attn_inputs(gen, B, H, Hkv, S, d, dt, dev)
    q = torch.randn((B, H, d), generator=gen, device=dev, dtype=dt)
    n = decode["final_length"]
    lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    nbytes = 2 * (2 * B * Hkv * n * d + 2 * B * H * d)
    flops = 4 * B * H * d * n
    lib, how = _sdpa(q[:, :, None], k[:, :, :n], v[:, :, :n], False)
    copies = decode_attention.copies
    rows.append(_attn_row(
        "decode_attention",
        lambda: decode_attention(q, k, v, lengths),
        lambda: ref.decode_reference(q, k, v, lengths),
        lambda: ref.decode_reference(q, k, v, lengths,
                                     max(1, n - PLANTED_DROP)),
        (lambda: lib()[:, :, 0]) if lib else None, how, flops, nbytes, hbm,
        decode["launches"], f"B={B} H={H} Hkv={Hkv} S={S} length={n} d={d} "
        f"bf16", calls=20, reps=7))
    copies = decode_attention.copies - copies
    rate = {key: nbytes / rows[-1][key] / 1e9 if rows[-1][key] else None
            for key in ("ms", "library_ms")}

    def call():
        return decode_attention(q, k, v, lengths)

    log(f"kernel decode_attention: {rate['ms']} TB/s achieved, "
        f"{rate['ms'] * 1e12 / hbm} of {hbm / 1e12} TB/s ({nbytes} bytes "
        f"of the function; the library call {rate['library_ms']} TB/s), "
        f"{copies} operand copies; device_ms, launches recorded of 20 = "
        f"{kernel_device_ms(call, 'decode_tc_kernel')} under the profiler, "
        f"{host_us_per_call(call)} us of host time a call")
    if copies:
        raise AssertionError(f"decode_attention copied {copies} operands of "
                             f"the serving layout")
    sweep = decode_split_sweep(call, B, Hkv, S, d)
    log(f"kernel decode_attention by split plan (waves: [chunk, n_split, "
        f"device ms]): {json.dumps(sweep)}")
    del q, k, v
    torch.cuda.empty_cache()
    log(decode_shape_line(get_spec("gemma2-2b").config, B, S, n, hbm, gen))
    return rows


def decode_split_sweep(call, B: int, Hkv: int, S: int, d: int) -> dict:
    """``call``'s device time under split plans for other grid sizes than
    the wrapper's (``WAVES`` of its module set to 1 to 16 in turn, then
    put back): {waves: [chunk, n_split, device ms]}."""
    import importlib
    plan = importlib.import_module("repro_torch.kernels.decode_attention")
    waves, out = plan.WAVES, {}
    try:
        for w in (1, 2, 4, 8, 16):
            plan.WAVES = w
            out[w] = [*plan.split_plan(B, Hkv, S, d),
                      kernel_device_ms(call, "decode_tc_kernel")[0]]
    finally:
        plan.WAVES = waves
    return out


def decode_shape_line(cfg, B: int, S: int, n: int, hbm: float, gen) -> str:
    """``decode_attention`` at a model's decode shape (its heads, window
    and softcap; B sequences of length n in an S-position cache in the
    model's layout, bf16): held against the plain version and timed beside
    its byte bound. A log line, so the kernel is read at another head dim
    and window than the serving row's."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    dev = torch.device("cuda")
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    win, cap = int(cfg.layer_windows().max()), cfg.attn_softcap or 0.0
    _, k, v = _attn_inputs(gen, B, H, Hkv, S, d, torch.bfloat16, dev)
    q = torch.randn((B, H, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    keys = min(n, win) if win else n
    nbytes = 2 * (2 * B * Hkv * keys * d + 2 * B * H * d)
    err, ratio = attn_err(decode_attention(q, k, v, lengths, win, cap),
                          ref.decode_reference(q, k, v, lengths, win, cap))
    if not ratio <= 1.0:
        raise AssertionError(f"decode_attention at {cfg.name}'s shape: max "
                             f"|kernel - plain| = {err}, {ratio}x the "
                             f"tolerance")

    def call():
        return decode_attention(q, k, v, lengths, win, cap)

    ms = time_ms(call, calls=5, reps=7)
    dev_ms, recorded = kernel_device_ms(call, "decode_tc_kernel")
    bound = nbytes / hbm * 1e3
    return (f"kernel decode_attention at {cfg.name}'s decode shape [B={B} "
            f"H={H} Hkv={Hkv} S={S} length={n} d={d} window={win} "
            f"softcap={cap} bf16]: kernel_ms={ms} (events, back to back) "
            f"device_ms={dev_ms} (profiler, {recorded} of 20 launches "
            f"recorded) bound_ms={bound} (bytes): "
            f"{nbytes / dev_ms / 1e9} TB/s of device time, {bound / dev_ms}"
            f" of the bound; {host_us_per_call(call)} us of host time a "
            f"call; max_abs_err={err} ({ratio}x the tolerance)")


def _attn_row(name, kern, plain, planted, lib, how, flops, nbytes, hbm,
              launches, shape, calls, reps, split=None) -> dict:
    """``planted``: the plain version with a fault planted (the first
    PLANTED_DROP keys of the longest rows left out); the check must find
    it out of tolerance, or it could not see such a kernel fault.
    ``split`` gives A for the bf16 flash route's check (``attn_err``)."""
    import torch
    want = plain()
    bound = split() if split is not None else None
    err, ratio = attn_err(kern(), want, bound)
    control_err, control = attn_err(planted(), want, bound)
    del bound
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
        "name": name, "route": "cuda", "source": ATTN_SOURCE[name],
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
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
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
    copies = flash_attention.copies
    pre = lm_prefill_phase(cfg, params, args.prefill_seq, PREFILL_BATCH,
                           min(PREFILL_WARM, args.prefill_seq), args.seed,
                           device, profile=True)
    log(f"lm prefill: {json.dumps(pre)}")
    if flash_attention.copies != copies:
        raise AssertionError(f"the prefill copied "
                             f"{flash_attention.copies - copies} attention "
                             f"operands")
    torch.cuda.empty_cache()
    copies = decode_attention.copies
    dec = lm_decode_phase(cfg, params, DECODE_BATCH, args.decode_cache,
                          args.decode_steps, args.seed, device, profile=4)
    log(f"lm decode: {json.dumps(dec)}")
    log(f"lm decode: {dec['profile']['device_ms_per_step']} ms of device "
        f"time per step under the profiler, {dec['ms_per_step']} ms per "
        f"step unprofiled")
    if decode_attention.copies != copies:
        raise AssertionError(f"the decode copied "
                             f"{decode_attention.copies - copies} cache "
                             f"operands")
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
    log(f"attention edge cases within (atol, rtol) {ATTN_TOL}, the bf16 "
        f"flash route plus {SPLIT_GROWTH} * A: {json.dumps(cases)}")
    return attention_kernel_rows(cfg, pre, dec, hbm)


def no_drop(cfg):
    """``cfg`` with a capacity factor of 8 E / K, so that C >= Tg in both
    branches of the capacity formula: no group of any size drops an
    assignment, and prefill computes the function decode does."""
    return dataclasses.replace(
        cfg, capacity_factor=8.0 * cfg.n_experts / cfg.top_k)


# kernel-name parts whose device time the MoE phase's profiles add up: the
# two attention kernels, cuBLAS's GEMMs (nvjet, gemm), sorts, gathers,
# elementwise passes and reductions (a name may hold two of them)
MOE_TRACK = ("flash_tc", "decode_tc", "nvjet", "gemm", "Sort", "gather",
             "elementwise", "reduce")


def moe_layer_profile(cfg, params, shape: tuple[int, int], device,
                      calls: int = 4) -> dict:
    """Device time of layer 0's ``moe_ffn`` alone on a bf16 input of
    ``shape`` = (B, S) normal rows (an RMS-normed activation's scale),
    under the profiler over ``calls`` calls: ms a call and its top
    kernels, the MoE layer's share of a prefill or a decode step."""
    import torch
    from repro_torch.models.transformer import layer_params, moe_ffn
    lp = layer_params(params, 0)
    x = torch.randn((*shape, cfg.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(17),
                    dtype=params["embed"].dtype)
    moe_ffn(cfg, lp, x)
    prof = device_profile(lambda: [moe_ffn(cfg, lp, x) for _ in range(calls)],
                          MOE_TRACK)
    return {"shape": list(shape), "calls": calls,
            "device_ms_per_call": prof["device_ms"] / calls,
            "busy_share": prof["busy_share"], "top": prof["top"],
            "tracked": prof["tracked"]}


def moe_serving(cfg, params, prefill: tuple[int, int],
                decode: tuple[int, int, int], seed: int, device,
                profile: bool) -> dict:
    """One MoE model's bf16 serving checks: a prefill of ``prefill`` =
    (batch, seq) tokens, ``decode`` = (batch, cache_len, steps) greedy
    decode steps, each launching ``flash_attention`` once a layer and
    ``decode_attention`` once a layer a step with no operand copy, then
    decode against prefill (capacity ``no_drop``, the prefill's expert
    choices forced: ``lm_consistency``) within CONSISTENCY_TOL with its
    off-by-one control above the limit."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    L = cfg.n_layers
    (pb, seq), (db, cache_len, steps) = prefill, decode
    copies = flash_attention.copies, decode_attention.copies
    pre = lm_prefill_phase(cfg, params, seq, pb, min(PREFILL_WARM, seq),
                           seed, device, profile=profile, track=MOE_TRACK)
    log(f"moe {cfg.name} prefill: {json.dumps(pre)}")
    torch.cuda.empty_cache()
    dec = lm_decode_phase(cfg, params, db, cache_len, steps, seed, device,
                          profile=4 if profile else 0, track=MOE_TRACK)
    log(f"moe {cfg.name} decode: {json.dumps(dec)}")
    if profile:
        log(f"moe {cfg.name} decode: "
            f"{dec['profile']['device_ms_per_step']} ms of device time per "
            f"step under the profiler, {dec['ms_per_step']} ms per step "
            f"unprofiled")
        for label, shape, whole in (
                ("prefill", (pb, seq), pre["profile"]["device_ms"]),
                ("decode step", (db, 1),
                 dec["profile"]["device_ms_per_step"])):
            layer = moe_layer_profile(cfg, params, shape, device)
            log(f"moe {cfg.name} MoE layer at the {label}'s shape: "
                f"{json.dumps(layer)}; {L} layers "
                f"{L * layer['device_ms_per_call']} of the {label}'s "
                f"{whole} ms of device time")
    torch.cuda.empty_cache()
    made = (flash_attention.copies - copies[0],
            decode_attention.copies - copies[1])
    if made != (0, 0):
        raise AssertionError(f"{cfg.name}: the prefill and decode copied "
                             f"{made} attention operands")
    want = {"flash_attention": L, "decode_attention": L * steps}
    got = {"flash_attention": pre["launches"].get("flash_attention", 0),
           "decode_attention": dec["launches"].get("decode_attention", 0)}
    if got != want:
        raise AssertionError(f"{cfg.name}: attention launches {got}, want "
                             f"{want}")
    cons = lm_consistency(no_drop(cfg), params, MOE_CONSISTENCY_PROMPT,
                          seed, device)
    cons["limit"] = CONSISTENCY_TOL * max(1.0, cons["max_abs_logit"])
    log(f"moe {cfg.name} decode vs prefill (bf16, capacity factor "
        f"{no_drop(cfg).capacity_factor}, the prefill's expert choices "
        f"forced; free routing recorded): {json.dumps(cons)}")
    if not cons["max_abs_diff"] <= cons["limit"]:
        raise AssertionError(f"{cfg.name}: bf16 decode logits drift from "
                             f"prefill: {cons}")
    if not cons["off_by_one_control_diff"] > cons["limit"]:
        raise AssertionError(f"{cfg.name}: a planted off-by-one is within "
                             f"the decode limit: {cons}")
    return {"launches": got, "prefill": pre, "decode": dec}


def moe_phase(args, hbm: float, device) -> dict:
    """The MoE LM serving phase: granite-moe-1b at full width and depth
    (the f32 card-vs-CPU check with its TF32 and routing-fault controls,
    the routing check with drops and its planted capacity fault, bf16
    serving at the LM phase's shapes with decode at B = MOE_DECODE_BATCH,
    a timed decode line at its shape), then phi3.5-moe at full width and
    MOE_SECOND_LAYERS layers; after each model, ``flash_attention`` held to
    its plain version at the model's prefill shape. Returns the attention
    launches by model."""
    import torch
    from repro_torch.configs.registry import get_spec
    from repro_torch.models.transformer import init_lm_params

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 checks
    cfg = get_spec(MOE_ARCH).config
    log(f"moe: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_head {cfg.d_head}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff} an "
        f"expert, vocab {cfg.vocab} (padded {cfg.padded_vocab}), "
        f"{cfg.param_count()} parameters ({cfg.active_param_count()} "
        f"active); decode_32k's batch 128 cut to {MOE_DECODE_BATCH}")
    t0 = time.perf_counter()
    check = lm_model_check(cfg, args.seed, device)
    log(f"moe model check (f32, card vs CPU): {json.dumps(check)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if not check["ok"]:
        raise AssertionError(f"{cfg.name}: f32 logits differ: {check}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    drops = moe_drop_check(cfg, args.seed, device)
    log(f"moe routing with drops (f32, card vs CPU, capacity factor "
        f"{MOE_DROP_FACTOR}): {json.dumps(drops)}")
    if not drops["ok"]:
        raise AssertionError(f"{cfg.name}: routing with drops differs: "
                             f"{drops}")
    planted = moe_drop_check(cfg, args.seed, device, planted=True)
    log(f"moe routing, capacity off by one on the card (control): kept "
        f"{planted['kept']} of {planted['assignments']} against "
        f"{planted['kept_recount']}, ok {planted['ok']} in "
        f"{time.perf_counter() - t0:.1f} s")
    if planted["ok"]:
        raise AssertionError(f"{cfg.name}: a planted capacity fault passes "
                             f"the routing check")

    params = init_lm_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), torch.bfloat16, device)
    launches = {cfg.name: moe_serving(
        cfg, params, (PREFILL_BATCH, args.prefill_seq),
        (MOE_DECODE_BATCH, args.decode_cache, args.decode_steps), args.seed,
        device, profile=True)["launches"]}
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(13)
    flash_serving_row(cfg, PREFILL_BATCH, args.prefill_seq,
                      launches[cfg.name], hbm, gen)
    n = args.decode_cache
    log(decode_shape_line(cfg, MOE_DECODE_BATCH, n, n, hbm, gen))
    torch.cuda.empty_cache()

    full = get_spec(MOE_SECOND_ARCH).config
    cfg = dataclasses.replace(full, n_layers=MOE_SECOND_LAYERS)
    t0 = time.perf_counter()
    _reset_peak(device)
    params = init_lm_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), torch.bfloat16, device)
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for v in params.values()
                     for t in (v.values() if isinstance(v, dict) else [v])
                     ) / 1e9
    log(f"moe: {cfg.name} at {MOE_SECOND_LAYERS} of {full.n_layers} layers "
        f"(all {full.param_count()} parameters take "
        f"{full.param_count() * 2 / 1e9:.1f} GB in bf16, the card has 80), "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"d_head {cfg.d_head}, {cfg.n_experts} experts top-{cfg.top_k}, d_ff "
        f"{cfg.d_ff}: {cfg.param_count()} parameters, {weights_gb} GB of "
        f"weights, drawn in {time.perf_counter() - t0:.1f} s, peak "
        f"{_peak_gb(device)} GB")
    seq = min(MOE_SECOND_SEQ, args.prefill_seq)
    launches[cfg.name] = moe_serving(
        cfg, params, (PREFILL_BATCH, seq),
        (MOE_SECOND_BATCH, seq, min(MOE_SECOND_STEPS, args.decode_steps)),
        args.seed, device, profile=False)["launches"]
    del params
    torch.cuda.empty_cache()
    flash_serving_row(cfg, PREFILL_BATCH, seq, launches[cfg.name], hbm, gen)
    return launches


# ---------------------------------------------------------------------------
# recsys and GNN serving phases
# ---------------------------------------------------------------------------


def sum_err(got, want, bound) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (bound + rtol * |want|)) with
    SUM_RTOL of want's dtype and ``bound`` = SUM_GROWTH * n * A per
    element: within tolerance when the second is at most 1."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    if not got.numel():
        return 0.0, 0.0
    rtol = SUM_RTOL[str(want.dtype).removeprefix("torch.")]
    w = want.float()
    delta = (got.float() - w).abs()
    return (float(delta.max()),
            float((delta / (bound + rtol * w.abs() + 1e-30)).max()))


def segment_bound(msg, dst, n_nodes):
    """SUM_GROWTH * in-degree * sum of |msg| per node and column."""
    import torch
    from repro_torch.kernels import ref
    absum = ref.segment_sum_sorted_reference(msg.abs().float(), dst,
                                             n_nodes)
    deg = ref.segment_sum_sorted_reference(
        torch.ones((msg.shape[0], 1), device=msg.device), dst, n_nodes)
    return SUM_GROWTH * deg * absum


def bag_bound(table, ids, mask, combiner):
    """SUM_GROWTH * NNZ * sum of |row * m| (over the count for mean)."""
    from repro_torch.kernels import ref
    return SUM_GROWTH * ids.shape[2] * ref.embedding_bag_reference(
        table.abs().float(), ids, mask.abs(), combiner)


def planted_segment(msg, dst):
    """msg with the first edge after every SEGMENT_CUT-edge boundary that
    cuts a run of equal dst zeroed: the plain version fed it leaves those
    edges out."""
    import torch
    at = torch.arange(SEGMENT_CUT, dst.shape[0], SEGMENT_CUT,
                      device=dst.device)
    at = at[dst[at] == dst[at - 1]]
    out = msg.clone()
    out[at] = 0
    return out


def planted_bag(mask):
    """mask with each bag's last entry zeroed: the plain version fed it
    leaves that entry out of the sum and the count."""
    out = mask.clone()
    out[..., -1] = 0
    return out


def check_sparse_cases(dev, dtypes=("float32", "bfloat16")) -> dict:
    """Both sparse kernels against their plain versions on the contract's
    edges: an empty graph and E = 0 to 5 (a last chunk off 16 bytes),
    nodes with no edges, one hot node and a hub whose run covers whole
    ranges, destinations outside [0, n_nodes), E off every span, D of 1,
    7, 16, 33 and past one column tile (300, 4096), msg or dst off 16
    bytes (the scalar route); empty batches, NNZ of 0, 1, 4, 33,
    37 and 600 (past the shared-memory ring), D of 1 to 300 on and off the
    16-byte width, bag counts off a chunk, a single bag, table, ids and
    mask off 16 bytes, weighted and all-masked bags. Random normal inputs
    within ``sum_err``'s tolerance, integer-valued ones exactly; each
    embedding_bag case with a live last entry also reads a planted fault
    (every bag's last entry left out) that must fail both checks. Returns
    the number of cases and, by dtype, the largest readings; raises after
    every case has run if any was out of tolerance."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.segment_mp import segment_sum_sorted

    gen = torch.Generator(device=dev).manual_seed(5)
    worst, bad = {}, []
    cases = 0

    def record(label, dtype, got, want, bound):
        nonlocal cases
        cases += 1
        err, ratio = sum_err(got, want, bound)
        w = worst.setdefault(dtype, {"max_abs_err": 0.0, "max_ratio": 0.0})
        w["max_abs_err"] = max(w["max_abs_err"], err)
        w["max_ratio"] = max(w["max_ratio"], ratio)
        if not ratio <= 1.0:
            bad.append(f"{label}: max |kernel - plain| {err}, {ratio}x the "
                       f"tolerance")

    def exact(label, got, want):
        nonlocal cases
        cases += 1
        if not torch.equal(got, want):
            bad.append(f"{label}: integer-valued sums differ")

    def sorted_dst(E, N, lo=0, hi=None, hot=None):
        d = torch.randint(lo, N if hi is None else hi, (E,), generator=gen,
                          device=dev)
        if hot is not None:
            d[torch.rand(E, generator=gen, device=dev) < 0.9] = hot
        return d.sort().values.to(torch.int32)

    def off16(t, k):
        """A contiguous copy of ``t`` starting ``k`` elements past a
        16-byte boundary."""
        flat = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
        out = flat[k:].view(t.shape)
        out.copy_(t)
        return out

    segment_cases = [  # label, E, N, D, dst, (msg, dst) elements off 16
        ("empty graph", 0, 0, 16, None, None),
        ("E=0", 0, 50, 16, None, None),
        ("one edge", 1, 1, 1, None, None),
        ("E=2", 2, 3, 7, None, None),
        ("E=3", 3, 2, 16, None, None),
        ("E=5, a last chunk off 16 bytes", 5, 4, 7, None, None),
        ("nodes without edges", 1000, 5000, 16, None, None),
        ("hot node", 100_003, 64, 16, dict(hot=5), None),
        # 90% of the edges on one node: whole ranges inside its run
        ("hub across whole ranges", 2_000_003, 5000, 16, dict(hot=7), None),
        ("hub across whole ranges, D=1", 2_000_003, 5000, 1, dict(hot=7),
         None),
        ("dst outside [0, n)", 20_000, 300, 7, dict(lo=-40, hi=340), None),
        ("E off the span, D=1", 8193, 700, 1, None, None),
        ("E off the span, D=16", 513, 40, 16, None, None),
        ("D=33", 9999, 2000, 33, None, None),
        ("D=300, two column tiles", 3001, 500, 300, None, None),
        ("D=4096, one column loop of 16 tiles", 203, 20, 4096, None, None),
        ("long runs", 1_000_003, 5000, 7, None, None),
        # the scalar route: msg or dst off 16 bytes
        ("msg off 16 bytes, D=16", 100_003, 3000, 16, None, (1, 0)),
        ("msg off 16 bytes, D=7", 100_003, 3000, 7, None, (3, 0)),
        ("dst off 16 bytes, D=1", 100_003, 3000, 1, None, (0, 1)),
        ("both off 16 bytes, hub", 300_001, 3000, 16, dict(hot=7), (2, 3)),
    ]
    for name in dtypes:
        dtype = getattr(torch, name)
        for label, E, N, D, kw, offs in segment_cases:
            dst = sorted_dst(E, max(N, 1), **(kw or {}))
            msg = torch.randn((E, D), generator=gen, device=dev).to(dtype)
            label = f"segment_sum_sorted {name} {label} E={E} N={N} D={D}"

            def kernel(m):
                if offs is None:
                    return segment_sum_sorted(m, dst, N)
                return segment_sum_sorted(off16(m, offs[0]),
                                          off16(dst, offs[1]), N)
            record(label, name, kernel(msg),
                   ref.segment_sum_sorted_reference(msg, dst, N),
                   segment_bound(msg, dst, N))
            msg = torch.randint(-2, 3, (E, D), generator=gen, device=dev,
                                dtype=torch.float32).to(dtype)
            exact(label + " integer", kernel(msg),
                  ref.segment_sum_sorted_reference(msg, dst, N))
    bag_cases = [  # B, F, NNZ, V, D
        (0, 3, 4, 10, 8), (1, 1, 1, 1, 1), (7, 3, 5, 100, 7),
        (64, 40, 4, 10_000, 32), (5, 2, 37, 500, 33), (3, 2, 3, 50, 300),
        (2, 3, 0, 10, 8), (3, 2, 600, 1000, 32),   # NNZ past the ring
    ]
    # the kernel's plans (kernels/embedding_bag.py:bag_plan): D on and off
    # the 16-byte width, one lane to 32 lanes a row and column loops; NNZ
    # of 1, 4 and 33; bag counts off a chunk (chunks are 128 bags at D =
    # 32 float32); a single bag
    for D in (1, 7, 16, 32, 33, 64, 128, 256):
        for NNZ in (1, 4, 33):
            bag_cases.append((67, 3, NNZ, 3000, D))
    bag_cases.append((1, 1, 4, 3000, 32))
    weights = torch.tensor([0.0, 0.5, 1.0, 2.0], device=dev)

    for name in dtypes:
        dtype = getattr(torch, name)
        for B, F, NNZ, V, D in bag_cases:
            ids = torch.randint(0, V, (B, F, NNZ), generator=gen, device=dev,
                                dtype=torch.int32)
            mask = weights[torch.randint(0, 4, (B, F, NNZ), generator=gen,
                                         device=dev)]
            if B:
                mask[0, 0] = 0.0                        # an all-masked bag
            table = torch.randn((V, D), generator=gen, device=dev).to(dtype)
            itable = torch.randint(-8, 9, (V, D), generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype)
            # the same values with table, ids and mask off 16 bytes: the
            # one-element loads, and the ring's plain copies of chunk ends
            layouts = [("", table, itable, ids, mask)]
            if B and NNZ and D in (32, 33):
                layouts.append((" off16", off16(table, 1), off16(itable, 1),
                                off16(ids, 1), off16(mask, 1)))
            planted = bool(B and NNZ) and bool((mask[..., -1] != 0).any())
            for combiner in ("mean", "sum"):
                want = ref.embedding_bag_reference(table, ids, mask,
                                                   combiner)
                iwant = ref.embedding_bag_reference(itable, ids, mask,
                                                    combiner)
                bound = bag_bound(table, ids, mask, combiner)
                label = (f"embedding_bag {name} {combiner} B={B} F={F} "
                         f"NNZ={NNZ} V={V} D={D}")
                for where, tab, itab, i, m in layouts:
                    record(label + where, name,
                           embedding_bag(tab, i, m, combiner), want, bound)
                    # sums of multiples of 0.5 are exact in any order, and
                    # both sides then divide and round the same float32
                    # value
                    exact(label + where + " integer",
                          embedding_bag(itab, i, m, combiner), iwant)
                if planted:      # each bag's last entry left out must fail
                    pm = planted_bag(mask)
                    if sum_err(ref.embedding_bag_reference(
                            table, ids, pm, combiner), want, bound)[1] <= 1:
                        bad.append(f"{label}: planted fault passes")
                    if torch.equal(ref.embedding_bag_reference(
                            itable, ids, pm, combiner), iwant):
                        bad.append(f"{label} integer: planted fault passes")
    _sync(dev)
    if bad:
        raise AssertionError("; ".join(bad))
    return {"cases": cases, **worst}


def _recsys_inputs(cfg, batch: int, seed: int, device) -> dict:
    """A ``recsys_batch`` of ``batch`` rows as tensors on ``device``."""
    import torch
    from repro_torch.data.recsys import recsys_batch
    b = recsys_batch(batch, cfg.n_sparse, cfg.vocab_per_field,
                     cfg.nnz_per_field, cfg.n_dense, seed=seed)
    return {k: torch.from_numpy(b[k]).to(device)
            for k in ("ids", "id_mask", "dense")}


def _ambiguous(vals, limit):
    """Positions of a descending top-k whose neighbour lies within
    ``limit``: their order may differ between two correct runs."""
    import torch
    close = (vals[:-1] - vals[1:]) <= limit
    amb = torch.zeros(vals.shape, dtype=torch.bool)
    amb[:-1] |= close
    amb[1:] |= close
    return amb


def recsys_model_check(cfg, seed: int, device, batch: int = 512,
                       ref_device="cpu") -> dict:
    """Float32 weights from ``seed``: Wide&Deep logits and scores of a
    ``batch``-row batch and the top-k retrieval of its first row on
    ``device`` (through the kernel on a card), then the same weights and
    batch on ``ref_device`` (the plain versions on the CPU). ok when every
    value is finite, max |diff| <= SPARSE_MODEL_TOL * max(1, max |logit|)
    for logits, scores and top-k scores, and the top-k indices agree
    wherever a score's neighbours lie farther apart than the limit. On a card two
    controls must exceed the limit: TF32 matmuls, and a mean that divides
    every bag by NNZ instead of its live count."""
    import torch
    from repro_torch.models import recsys
    dev = torch.device(device)
    params = recsys.init_recsys_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    data = _recsys_inputs(cfg, batch, seed + 1, "cpu")

    def run(p, d):
        b = {key: v.to(d) for key, v in data.items()}
        one = {key: v[:1] for key, v in b.items()}
        vals, idx = recsys.retrieval_topk(cfg, p, one)
        return (recsys.wide_deep_logits(cfg, p, b).cpu(),
                recsys.recsys_score(cfg, p, b).cpu(), vals.cpu(), idx.cpu())

    got = run(params, dev)
    ref_dev = torch.device(ref_device)
    want = run(_params_to(params, ref_dev), ref_dev)
    limit = SPARSE_MODEL_TOL * max(1.0, float(want[0].abs().max()))
    diff = [float((g - w).abs().max()) for g, w in zip(got[:3], want[:3])]
    amb = _ambiguous(want[2][0], limit)
    idx_ok = bool(torch.equal(got[3][0][~amb], want[3][0][~amb]))
    finite = all(bool(torch.isfinite(g).all()) for g in got[:3])
    controls = {}
    if dev.type == "cuda":
        matmul = torch.backends.cuda.matmul
        tf32, matmul.allow_tf32 = matmul.allow_tf32, True
        try:
            controls["tf32"] = float((run(params, dev)[0] - want[0])
                                     .abs().max())
        finally:
            matmul.allow_tf32 = tf32
        kernel = recsys.bag_kernel
        recsys.bag_kernel = (lambda t, i, m, combiner="mean":
                             kernel(t, i, m, "sum") / i.shape[2])
        try:
            controls["mean_over_nnz"] = float((run(params, dev)[0] - want[0])
                                              .abs().max())
        finally:
            recsys.bag_kernel = kernel
    return {"batch": batch, "max_abs_diff_logits": diff[0],
            "max_abs_diff_scores": diff[1], "max_abs_diff_topk": diff[2],
            "max_abs_logit": float(want[0].abs().max()), "limit": limit,
            "topk_index_agree": float((got[3] == want[3]).float().mean()),
            "topk_ambiguous": int(amb.sum()), "controls": controls,
            "ok": finite and max(diff) <= limit and idx_ok
            and all(c > limit for c in controls.values())}


def timed_calls(fn, calls: int, device) -> dict:
    """One warm-up call of ``fn``; one call with the launch counts set to
    0 just before and read just after (its result is returned under
    ``out``); then ``calls`` more, each timed on the host clock to a
    synchronise. Peak device memory is read after them all."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    fn()
    _reset_peak(device)
    reset_launch_counts()
    out = fn()
    _sync(device)
    launches = launch_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"out": out, "calls": calls,
            "median_ms": statistics.median(times), "min_ms": min(times),
            "launches": launches, "peak_gb": _peak_gb(device)}


def recsys_serve(cfg, params, batch: int, seed: int, device, calls: int,
                 profile: bool = False) -> dict:
    """``recsys_score`` on one ``recsys_batch`` of ``batch`` rows already on
    the device, through ``timed_calls``; ``profile`` adds a call under the
    profiler."""
    from repro_torch.models.recsys import recsys_score
    data = _recsys_inputs(cfg, batch, seed, device)
    res = timed_calls(lambda: recsys_score(cfg, params, data), calls,
                      device)
    scores = res.pop("out")
    if scores.shape != (batch,) or not bool(
            ((scores >= 0) & (scores <= 1)).all()):
        raise AssertionError(f"scores {tuple(scores.shape)} not in [0, 1]")
    res.update(batch=batch, samples_per_s=batch / res["median_ms"] * 1e3)
    if profile:
        res["profile"] = device_profile(
            lambda: recsys_score(cfg, params, data))
    return res


def recsys_retrieval(cfg, params, seed: int, device, calls: int,
                     profile: bool = False) -> dict:
    """``retrieval_topk`` of one query against every candidate, through
    ``timed_calls``."""
    import torch
    from repro_torch.models.recsys import retrieval_topk
    data = _recsys_inputs(cfg, 1, seed, device)
    res = timed_calls(lambda: retrieval_topk(cfg, params, data), calls,
                      device)
    vals, idx = res.pop("out")
    if not bool(torch.isfinite(vals).all()) or \
            not bool((vals[0, :-1] >= vals[0, 1:]).all()):
        raise AssertionError("top-k scores are not finite and descending")
    res.update(candidates=cfg.n_candidates, k=idx.shape[1])
    if profile:
        res["profile"] = device_profile(
            lambda: retrieval_topk(cfg, params, data))
    return res


def sparse_row(name, launches, err, kern, plain, lib, nbytes, hbm) -> dict:
    """A kernel row of a sparse kernel: its time, its plain version's and
    one PyTorch call's (``lib``), beside the time of moving ``nbytes`` at
    the card's memory rate (two flops per loaded element: bytes bind)."""
    return {
        "name": name, "route": "cuda", "source": SPARSE_SOURCE,
        "replaces": SPARSE_REPLACES[name],
        "launches": int(launches.get(name, 0)), "max_abs_err": err,
        "ms": time_ms(kern), "plain_ms": time_ms(plain, calls=1, reps=3),
        "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(lib),
    }


def bag_kernel_row(cfg, params, data, launches, hbm) -> dict:
    """``embedding_bag`` at a serving batch's shape (the model's unified
    table and field-offset ids) against its plain version on the same card
    inputs: exactly on an integer-valued table with weights in {0, 1, 2},
    per element on the model's float32 table and a bfloat16 copy under
    both combiners; each against a planted fault (the plain version
    leaving out every bag's last entry) that must fail it. Timed beside
    its bound and ``F.embedding_bag``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import bag_plan, embedding_bag
    from repro_torch.models.recsys import _field_ids

    table = params["embed"]
    dev = table.device
    gen = torch.Generator(device=dev).manual_seed(13)
    ids = _field_ids(data["ids"], cfg.vocab_per_field)
    mask = data["id_mask"]
    B, F_, NNZ = ids.shape
    V, D = table.shape
    shape = f"B={B} F={F_} NNZ={NNZ} V={V} D={D}"
    plan = bag_plan(B * F_, NNZ, D, table.element_size(),
                    table.data_ptr() % 16 == 0)
    checks = {}

    itable = torch.randint(-8, 9, (V, D), generator=gen, device=dev,
                           dtype=torch.float32)
    imask = mask * torch.randint(1, 3, mask.shape, generator=gen,
                                 device=dev, dtype=torch.float32)
    for combiner in ("mean", "sum"):
        want = ref.embedding_bag_reference(itable, ids, imask, combiner)
        got = embedding_bag(itable, ids, imask, combiner)
        planted = ref.embedding_bag_reference(itable, ids,
                                              planted_bag(imask), combiner)
        checks[f"exact {combiner}"] = [float((got - want).abs().max()),
                                       float((planted - want).abs().max())]
        del want, got, planted
    del itable, imask
    for name in ("float32", "bfloat16"):
        tab = table if name == "float32" else table.to(torch.bfloat16)
        for combiner in ("mean", "sum"):
            want = ref.embedding_bag_reference(tab, ids, mask, combiner)
            bound = bag_bound(tab, ids, mask, combiner)
            err = sum_err(embedding_bag(tab, ids, mask, combiner), want,
                          bound)
            control = sum_err(ref.embedding_bag_reference(
                tab, ids, planted_bag(mask), combiner), want, bound)
            checks[f"{name} {combiner}"] = [*err, *control]
            del want, bound
        del tab
    _sync(dev)
    bad = [k for k, v in checks.items()
           if (not (v[0] == 0 and v[1] > 0) if k.startswith("exact")
               else not v[1] <= 1.0 < v[3])]
    if bad:
        raise AssertionError(f"embedding_bag [{shape}]: {bad}: {checks}")

    flat, w = ids.view(-1, NNZ), mask.view(-1, NNZ)

    def library():   # sum with per-sample weights, then mean's divide
        return (F.embedding_bag(flat, table, mode="sum",
                                per_sample_weights=w)
                / w.sum(1, keepdim=True).clamp(min=1.0))

    lib_err = float((library().view(B, F_, D) - ref.embedding_bag_reference(
        table, ids, mask)).abs().max())
    n = ids.numel()
    uniq = int(torch.unique(ids).numel())
    addressed = 8 * n + B * F_ * D * 4          # ids, mask, out
    row = sparse_row(
        "embedding_bag", launches, checks["float32 mean"][0],
        lambda: embedding_bag(table, ids, mask),
        lambda: ref.embedding_bag_reference(table, ids, mask), library,
        addressed + uniq * D * 4, hbm)
    log(f"kernel embedding_bag [{shape} mean f32 {plan}]: "
        f"kernel_ms={row['ms']} "
        f"bound_ms={row['bound_ms']} (bytes: ids, mask, {uniq} distinct "
        f"rows of {n} lookups, out; "
        f"{(addressed + n * D * 4) / hbm * 1e3} ms reading every "
        f"addressed row) plain_ms={row['plain_ms']} "
        f"library_ms={row['library_ms']} (F.embedding_bag sum with "
        f"per_sample_weights, then the divide by the count; max |library "
        f"- plain| {lib_err}) launches={row['launches']} checks "
        f"[max_abs_err, ratio, planted max_abs_err, planted ratio]: "
        f"{json.dumps(checks)}")
    return row


def recsys_phase(args, hbm: float | None, device) -> list[dict]:
    """Wide&Deep at full width: card against CPU, then ``serve_p99``,
    ``serve_bulk`` and ``retrieval_cand``; returns the ``embedding_bag``
    row (none off the card)."""
    import torch
    from repro_torch.configs.registry import get_spec
    from repro_torch.models.recsys import init_recsys_params

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 checks
    spec = get_spec(RECSYS_ARCH)
    cfg = spec.config
    log(f"recsys: {cfg.name} ({spec.source}) {cfg.n_sparse} fields x "
        f"{cfg.vocab_per_field} ids, embed {cfg.embed_dim}, nnz "
        f"{cfg.nnz_per_field}, MLP {cfg.mlp_dims}, {cfg.n_candidates} x "
        f"{cfg.retrieval_dim} candidates, {cfg.param_count()} parameters, "
        f"float32; shapes {spec.shapes}")
    t0 = time.perf_counter()
    check = recsys_model_check(cfg, args.seed, device)
    log(f"recsys model check (f32, card vs CPU): {json.dumps(check)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if not check["ok"]:
        raise AssertionError(f"recsys outputs differ: {check}")
    torch.cuda.empty_cache()

    params = init_recsys_params(cfg, torch.Generator(device=device)
                                .manual_seed(args.seed), device)
    cells = {}
    for shape, calls in (("serve_p99", 50), ("serve_bulk", 7)):
        batch = spec.shapes[shape]["batch"]
        cells[shape] = recsys_serve(cfg, params, batch, args.seed + 2,
                                    device, calls, profile=True)
        log(f"recsys {shape}: {json.dumps(cells[shape])}")
    ret = recsys_retrieval(cfg, params, args.seed + 3, device, calls=20,
                           profile=True)
    log(f"recsys retrieval_cand: {json.dumps(ret)}")
    for name, res in (*cells.items(), ("retrieval_cand", ret)):
        if res["launches"] != {"embedding_bag": 1}:
            raise AssertionError(f"recsys {name}: launches "
                                 f"{res['launches']}, want one "
                                 f"embedding_bag")
    data = _recsys_inputs(cfg, spec.shapes["serve_bulk"]["batch"],
                          args.seed + 2, device)
    row = bag_kernel_row(cfg, params, data, cells["serve_bulk"]["launches"],
                         hbm)
    del params, data
    torch.cuda.empty_cache()
    return [row]


def _drop_run_starts(kernel):
    """``segment_sum_sorted`` with a planted fault: the first edge of every
    destination's run left out."""
    import torch

    def faulty(msg, dst, n_nodes, out=None):
        first = torch.ones(dst.shape, dtype=torch.bool, device=dst.device)
        first[1:] = dst[1:] != dst[:-1]
        return kernel(msg * (~first)[:, None].to(msg.dtype), dst, n_nodes,
                      out)
    return faulty


def _clamped_max(seg_max):
    """``gnn.seg_max`` with a planted fault: ``scatter_reduce_`` with
    ``include_self=True``, which takes the zeroed rows into every max, so
    a max below 0 reads 0 (and, through ``seg_min``, a min above 0)."""
    def faulty(x, idx, n, out=None):
        out = x.new_zeros((n, x.shape[1])) if out is None else out.zero_()
        return out.scatter_reduce_(0, idx.long()[:, None].expand_as(x), x,
                                   "amax", include_self=True)
    return faulty


def _permuted_rel(rel):
    """``gnn._rel`` with a planted fault: the edge vectors' components
    turned (x, y, z) -> (y, z, x), a fixed rotation that does not commute
    with the check's."""
    def faulty(pos, a, b):
        return rel(pos, a, b)[:, [1, 2, 0]]
    return faulty


def gnn_config(arch: str, shape: str):
    """The registry's config of ``arch`` at GNN shape ``shape``: GCN and
    PNA take the shape's d_feat (1,433 at full_graph_sm, 100 at
    ogb_products), as the reference's cells pin it."""
    from repro_torch.configs.registry import get_spec
    spec = get_spec(arch)
    cfg = spec.config
    if cfg.model in ("gcn", "pna") and "d_feat" in spec.shapes[shape]:
        cfg = dataclasses.replace(cfg, d_feat=spec.shapes[shape]["d_feat"])
    return cfg


def check_shape(cfg) -> str:
    """The shape of the card-vs-CPU check: full_graph_sm for GCN and PNA,
    molecule for EGNN and NequIP."""
    return "full_graph_sm" if cfg.model in ("gcn", "pna") else "molecule"


def gnn_inputs(cfg, seed: int) -> dict:
    """numpy inputs at ``check_shape``: ``cora_like`` (edges as generated,
    unsorted) or ``molecule_batch`` (edges unsorted, graph ids
    ascending)."""
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data.graphs import cora_like, molecule_batch
    sh = GNN_SHAPES[check_shape(cfg)]
    if cfg.model in ("gcn", "pna"):
        data = cora_like(sh["n_nodes"], sh["n_edges"], cfg.d_feat,
                         cfg.n_classes, seed=seed)
        return {k: data[k] for k in ("feat", "edge_index")}
    data = molecule_batch(sh["n_graphs"], sh["nodes_per"], sh["edges_per"],
                          cfg.n_species, seed=seed)
    return {k: data[k] for k in ("species", "coords", "edge_index",
                                 "graph_ids", "energy")}


def gnn_outputs(cfg, params, data: dict, device) -> dict:
    """The model's outputs on ``data`` (numpy) moved to ``device``, back on
    the CPU: GCN's and PNA's logits; EGNN's h, coordinates and energies;
    NequIP's l0, l1, l2 and energies (energies through ``*_energy``, a
    second forward)."""
    import torch
    from repro_torch.models import gnn
    t = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    if cfg.model in ("gcn", "pna"):
        fwd = gnn.gcn_forward if cfg.model == "gcn" else gnn.pna_forward
        out = {"logits": fwd(cfg, params, t["feat"], t["edge_index"])}
    else:
        args = (cfg, params, t["species"], t["coords"], t["edge_index"])
        if cfg.model == "egnn":
            out = dict(zip(("h", "x"), gnn.egnn_forward(*args)))
            energy = gnn.egnn_energy
        else:
            out = gnn.nequip_forward(*args)
            energy = gnn.nequip_energy
        out["energy"] = energy(*args, t["graph_ids"], len(data["energy"]))
    return {k: v.cpu() for k, v in out.items()}


def gnn_model_check(cfg, seed: int, device, ref_device="cpu") -> dict:
    """Float32 weights from ``seed`` at ``check_shape``: every output on
    ``device`` (through the kernel on a card) against the same weights on
    ``ref_device`` (the plain versions on the CPU). ok when every output is
    finite and each within SPARSE_MODEL_TOL * max(1, max |output|)
    (``ratio`` <= 1), and on a card when every control exceeds it: TF32
    matmuls, a planted fault that leaves every node's first edge out of the
    aggregation, and for PNA ``scatter_reduce_`` with ``include_self``."""
    import torch
    from repro_torch.models import gnn
    data = gnn_inputs(cfg, seed)
    dev = torch.device(device)
    params = gnn.gnn_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    got = gnn_outputs(cfg, params, data, dev)
    ref_dev = torch.device(ref_device)
    want = gnn_outputs(cfg, _params_to(params, ref_dev), data, ref_dev)
    limits = {k: SPARSE_MODEL_TOL * max(1.0, float(w.abs().max()))
              for k, w in want.items()}
    diffs = {k: float((got[k] - want[k]).abs().max()) for k in want}

    def ratio(out):
        return max(float((out[k] - want[k]).abs().max()) / limits[k]
                   for k in want)

    controls = {}
    if dev.type == "cuda":
        matmul = torch.backends.cuda.matmul
        tf32, matmul.allow_tf32 = matmul.allow_tf32, True
        try:
            controls["tf32"] = ratio(gnn_outputs(cfg, params, data, dev))
        finally:
            matmul.allow_tf32 = tf32
        with patched(gnn, "segment_sum_sorted", _drop_run_starts):
            controls["first_edge_dropped"] = ratio(
                gnn_outputs(cfg, params, data, dev))
        if cfg.model == "pna":
            with patched(gnn, "seg_max", _clamped_max):
                controls["max_include_self"] = ratio(
                    gnn_outputs(cfg, params, data, dev))
    return {"model": cfg.model, "shape": check_shape(cfg),
            "nodes": len(data["coords" if "coords" in data else "feat"]),
            "edges": len(data["edge_index"]), "max_abs_diff": max(
                diffs.values()), "diffs": diffs, "limits": limits,
            "ratio": ratio(got), "controls": controls,
            "ok": all(bool(torch.isfinite(v).all()) for v in got.values())
            and ratio(got) <= 1.0
            and all(c > 1.0 for c in controls.values())}


def random_rotation(seed: int) -> np.ndarray:
    """A rotation (det +1) drawn from ``seed``: the Q of a normal 3x3
    matrix's QR with R's diagonal made positive, a column flipped where
    its determinant is -1."""
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def rotation_check(cfg, seed: int, device, planted: bool = False) -> dict:
    """EGNN or NequIP on the molecule inputs on ``device`` at coordinates x
    and at R x, R from ``seed``: energies (and EGNN's h, NequIP's l0)
    invariant, EGNN's coordinates R x', NequIP's l1 R v and l2 R M R^T,
    each within ROTATION_TOL * max(1, max |want|) (``ratios`` <= 1).
    ``planted`` turns the edge vectors' components (``_permuted_rel``),
    which must fail it."""
    import torch
    from repro_torch.models import gnn
    dev = torch.device(device)
    data = gnn_inputs(cfg, seed)
    R = random_rotation(seed)
    turned = dict(data, coords=(data["coords"] @ R.T).astype(np.float32))
    params = gnn.gnn_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                          dev)
    with (patched(gnn, "_rel", _permuted_rel) if planted
          else contextlib.nullcontext()):
        base = gnn_outputs(cfg, params, data, dev)
        got = gnn_outputs(cfg, params, turned, dev)
    r = torch.from_numpy(R.astype(np.float32))
    want = dict(base)
    for k in ("x", "l1"):
        if k in want:
            want[k] = base[k] @ r.T
    if "l2" in want:
        want["l2"] = r @ base["l2"] @ r.T
    ratios = {k: float((got[k] - want[k]).abs().max())
              / (ROTATION_TOL * max(1.0, float(want[k].abs().max())))
              for k in want}
    return {"model": cfg.model, "ratios": ratios,
            "ok": max(ratios.values()) <= 1.0}


def gnn_graph(n_nodes: int, n_edges: int, d_feat: int, seed: int,
              device, n_species: int = 16) -> dict:
    """``power_law_graph`` drawn on ``device`` and sorted by destination
    there (each timed to a synchronise), with normal features, species in
    [0, ``n_species``) and coordinates normal(0, 1.5)."""
    import torch
    from repro_torch.data.graphs import power_law_graph
    from repro_torch.models.gnn import is_sorted_by_dst, sort_by_dst
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    edges = power_law_graph(n_nodes, n_edges, gen)
    _sync(device)
    t1 = time.perf_counter()
    edges = sort_by_dst(edges)
    _sync(device)
    t2 = time.perf_counter()
    if not is_sorted_by_dst(edges):
        raise AssertionError("sort_by_dst left dst unsorted")
    feat = torch.randn((n_nodes, d_feat), generator=gen, device=device)
    species = torch.randint(0, n_species, (n_nodes,), generator=gen,
                            device=device, dtype=torch.int32)
    coords = torch.randn((n_nodes, 3), generator=gen, device=device) * 1.5
    return {"edges": edges, "feat": feat, "species": species,
            "coords": coords, "draw_s": t1 - t0, "sort_s": t2 - t1}


def gnn_call(cfg, params, graph: dict, entry: bool = True):
    """One model call on ``graph`` (edges sorted beforehand), as a closure.
    ``entry``: what a user calls, GCN's and PNA's logits and EGNN's and
    NequIP's energies of the graph as one molecule (G = 1, as the
    reference's cells take ogb_products); else the forward."""
    import torch
    from repro_torch.models import gnn
    e = graph["edges"]
    if cfg.model in ("gcn", "pna"):
        fwd = gnn.gcn_forward if cfg.model == "gcn" else gnn.pna_forward
        return lambda: fwd(cfg, params, graph["feat"], e)
    args = (cfg, params, graph["species"], graph["coords"], e)
    if not entry:
        fwd = gnn.egnn_forward if cfg.model == "egnn" else gnn.nequip_forward
        return lambda: fwd(*args)
    energy = gnn.egnn_energy if cfg.model == "egnn" else gnn.nequip_energy
    ids = torch.zeros(graph["coords"].shape[0], dtype=torch.int32,
                      device=e.device)
    return lambda: energy(*args, ids, 1)


def gnn_serve(cfg, params, graph: dict, device, calls: int,
              profile: bool = False) -> dict:
    """``gnn_call`` on a graph sorted beforehand, through ``timed_calls``;
    ``profile`` adds a call under the profiler (device only)."""
    import torch
    from repro_torch.models.gnn import degrees, edge_chunks
    edges = graph["edges"]
    n, E = graph["feat"].shape[0], edges.shape[0]
    fn = gnn_call(cfg, params, graph)
    res = timed_calls(fn, calls, device)
    out = res.pop("out")
    want = (n, cfg.n_classes) if cfg.model in ("gcn", "pna") else (1,)
    if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{cfg.name} output {tuple(out.shape)} not "
                             f"finite or not {want}")
    del out
    dst = edges[:, 1].contiguous()
    res.update(model=cfg.name, nodes=n, edges=E,
               chunks=len(edge_chunks(dst, n)),
               max_in_degree=float(degrees(dst, n).max()),
               draw_s=graph["draw_s"], sort_s=graph["sort_s"],
               edges_per_s=E / res["median_ms"] * 1e3)
    if cfg.model in ("gcn", "pna"):
        res["d_feat"] = cfg.d_feat
    del dst
    if profile:
        res["profile"] = device_profile(fn, cpu=False)
    return res


def expected_widths(cfg, n_chunks: int) -> dict:
    """{D: launches} of ``segment_sum_sorted`` in one forward, from the
    model and its chunk count: GCN the degrees (D = 1) and one a layer
    (each layer's output width); PNA the degrees and, a chunk and layer,
    the messages' sum and their squares' (D = hidden); EGNN the degrees
    and, a chunk and layer, the coordinate update (D = 3) and the messages
    (D = hidden); NequIP, a chunk and layer, l0, l1 and l2 (D = 2C, 9C,
    18C)."""
    L, H, k = cfg.n_layers, cfg.d_hidden, n_chunks
    if cfg.model == "gcn":
        want = {1: 1}
        for d in [H] * (L - 1) + [cfg.n_classes]:
            want[d] = want.get(d, 0) + 1
        return want
    if cfg.model == "pna":
        return {1: 1, H: L * k * (1 + ("std" in cfg.aggregators))}
    if cfg.model == "egnn":
        return {1: 1, 3: L * k, H: L * k}
    return {2 * H: L * k, 9 * H: L * k, 18 * H: L * k}


def segment_widths(cfg, params, graph: dict) -> dict:
    """The launches of ``segment_sum_sorted`` in one forward by the width
    D of their messages, {D: launches} (counts set to 0 just before the
    forward, read just after; they must sum to the wrapper's count), and
    the forward's outputs all finite. Off the card every width counts 0
    launches."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import gnn
    widths: dict[int, int] = {}

    def tally(kernel):
        def counted(msg, dst, n_nodes, out=None):
            before = launch_counts().get("segment_sum_sorted", 0)
            res = kernel(msg, dst, n_nodes, out)
            widths[msg.shape[1]] = widths.get(msg.shape[1], 0) + \
                launch_counts().get("segment_sum_sorted", 0) - before
            return res
        return counted

    fn = gnn_call(cfg, params, graph, entry=False)
    with patched(gnn, "segment_sum_sorted", tally):
        reset_launch_counts()
        out = fn()
        _sync(graph["edges"].device)
        counts = launch_counts()
    if sum(widths.values()) != counts.get("segment_sum_sorted", 0):
        raise AssertionError(f"segment widths {widths} vs launches {counts}")
    outs = out.values() if isinstance(out, dict) else \
        out if isinstance(out, tuple) else (out,)
    if not all(bool(torch.isfinite(t).all()) for t in outs):
        raise AssertionError(f"{cfg.name} forward output not finite")
    return widths


def gnn_molecule_latency(cfg, seed: int, device, calls: int) -> dict:
    """EGNN's or NequIP's energies of one molecule batch at the molecule
    shape (the check's inputs, edges unsorted as generated) on ``device``,
    through ``timed_calls``: one forward of one chunk, and the per-graph
    sum."""
    import torch
    from repro_torch.models import gnn
    data = gnn_inputs(cfg, seed)
    t = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    params = gnn.gnn_init(cfg, torch.Generator(device=device).manual_seed(
        seed), device)
    energy = gnn.egnn_energy if cfg.model == "egnn" else gnn.nequip_energy
    res = timed_calls(lambda: energy(cfg, params, t["species"], t["coords"],
                                     t["edge_index"], t["graph_ids"],
                                     len(data["energy"])), calls, device)
    out = res.pop("out")
    if out.shape != (len(data["energy"]),) or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{cfg.name} energies {tuple(out.shape)}")
    res.update(model=cfg.name, graphs=len(data["energy"]),
               nodes=len(data["species"]), edges=len(data["edge_index"]))
    return res


def segment_exact(dst, n_nodes: int, d: int, gen) -> list[float]:
    """[max |kernel - plain|, max |planted - plain|] of
    ``segment_sum_sorted`` on integer-valued [E, d] messages in {-2, ...,
    2} (every sum is under 2^24, so exact in any order): the first must be
    0, the second (``planted_segment``) not."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_mp import segment_sum_sorted
    msg = torch.randint(-2, 3, (dst.shape[0], d), generator=gen,
                        device=dst.device, dtype=torch.float32)
    want = ref.segment_sum_sorted_reference(msg, dst, n_nodes)
    got = segment_sum_sorted(msg, dst, n_nodes)
    planted = ref.segment_sum_sorted_reference(planted_segment(msg, dst),
                                               dst, n_nodes)
    return [float((got - want).abs().max()),
            float((planted - want).abs().max())]


def segment_kernel_rows(dst, n_nodes: int, widths: dict, hbm) -> list:
    """``segment_sum_sorted`` at each width a forward launches at this
    shape (destination-sorted ``dst``, [E, D] messages) against its plain
    version on the same card inputs: exactly on integer-valued messages
    (``segment_exact``), per element on normal messages in float32 and
    bfloat16 and on the scalar route (msg one element off 16 bytes); each
    against a planted fault (``planted_segment``) that must fail it. Timed
    beside its bound and ``index_add_``; one row a width, ``launches`` the
    forwards' launches at that width and shape."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_mp import segment_plan, segment_sum_sorted

    dev = dst.device
    gen = torch.Generator(device=dev).manual_seed(17)
    E = dst.shape[0]
    rows = []
    for d in sorted(widths, reverse=True):
        shape = f"E={E} N={n_nodes} D={d}"
        checks = {"exact": segment_exact(dst, n_nodes, d, gen)}
        scalar_ms = None
        for name in ("float32", "bfloat16", "float32 off16"):
            msg = torch.randn((E, d), generator=gen, device=dev).to(
                getattr(torch, name.split()[0]))
            want = ref.segment_sum_sorted_reference(msg, dst, n_nodes)
            bound = segment_bound(msg, dst, n_nodes)
            kmsg = msg
            if name.endswith("off16"):       # the scalar route
                flat = torch.empty(E * d + 1, dtype=msg.dtype, device=dev)
                kmsg = flat[1:].view(E, d)
                kmsg.copy_(msg)
                scalar_ms = time_ms(
                    lambda: segment_sum_sorted(kmsg, dst, n_nodes))
            err = sum_err(segment_sum_sorted(kmsg, dst, n_nodes), want,
                          bound)
            control = sum_err(ref.segment_sum_sorted_reference(
                planted_segment(msg, dst), dst, n_nodes), want, bound)
            checks[name] = [*err, *control]
            del msg, kmsg, want, bound
        _sync(dev)
        bad = [] if (checks["exact"][0] == 0 and checks["exact"][1] > 0) \
            else ["exact"]
        bad += [k for k, v in checks.items()
                if k != "exact" and not v[1] <= 1.0 < v[3]]
        if bad:
            raise AssertionError(f"segment_sum_sorted [{shape}]: {bad}: "
                                 f"{checks}")

        msg = torch.randn((E, d), generator=gen, device=dev)
        lib_err = float((torch.zeros((n_nodes, d), device=dev)
                         .index_add_(0, dst, msg)
                         - ref.segment_sum_sorted_reference(msg, dst,
                                                            n_nodes))
                        .abs().max())
        row = sparse_row(
            "segment_sum_sorted", {"segment_sum_sorted": widths[d]},
            checks["float32"][0],
            lambda: segment_sum_sorted(msg, dst, n_nodes),
            lambda: ref.segment_sum_sorted_reference(msg, dst, n_nodes),
            lambda: torch.zeros((n_nodes, d), device=dev).index_add_(
                0, dst, msg),
            E * d * 4 + E * 4 + n_nodes * d * 4, hbm)
        row["shape"] = shape
        rows.append(row)
        log(f"kernel segment_sum_sorted [{shape} f32 "
            f"{segment_plan(E, d, 4, True)}]: kernel_ms={row['ms']} "
            f"bound_ms={row['bound_ms']} (bytes) plain_ms={row['plain_ms']} "
            f"library_ms={row['library_ms']} (zeros + index_add_; max "
            f"|library - plain| {lib_err}) launches={row['launches']}; "
            f"scalar route (msg off 16 bytes) {scalar_ms} ms; checks "
            f"[max_abs_err, ratio, planted max_abs_err, planted ratio]: "
            f"{json.dumps(checks)}")
        del msg
        torch.cuda.empty_cache()
    return rows


def gnn_phase(args, hbm: float | None, device) -> list[dict]:
    """GCN, PNA, EGNN and NequIP inference: each card against CPU at
    ``check_shape`` (EGNN and NequIP also under a rotation), then each
    forward on ogb_products' size drawn on the card, and EGNN's and
    NequIP's energies at the molecule shape; returns the
    ``segment_sum_sorted`` rows: GCN's widths and the degrees at the whole
    graph's shape, the new widths at a median chunk's (none off the
    card)."""
    import torch
    from repro_torch.configs.registry import GNN_SHAPES, get_spec
    from repro_torch.models.gnn import EDGE_CHUNK, edge_chunks, gnn_init

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 checks
    for arch in (GNN_ARCH,) + GNN_ZOO:
        spec = get_spec(arch)
        cfg = gnn_config(arch, "full_graph_sm")
        t0 = time.perf_counter()
        check = gnn_model_check(cfg, args.seed, device)
        log(f"gnn {cfg.name} ({spec.source}) {cfg.n_layers} layers, hidden "
            f"{cfg.d_hidden}: model check (f32, card vs CPU, "
            f"{check_shape(cfg)} {spec.shapes[check_shape(cfg)]}): "
            f"{json.dumps(check)} in {time.perf_counter() - t0:.1f} s")
        if not check["ok"]:
            raise AssertionError(f"{cfg.name} outputs differ: {check}")
        if cfg.model in ("egnn", "nequip"):
            rot = rotation_check(cfg, args.seed, device)
            planted = rotation_check(cfg, args.seed, device, planted=True)
            log(f"gnn {cfg.name} rotation check on the card (ROTATION_TOL "
                f"{ROTATION_TOL}): {json.dumps(rot)}; planted rel "
                f"permutation: {json.dumps(planted)}")
            if not rot["ok"] or planted["ok"]:
                raise AssertionError(f"{cfg.name} rotation check: {rot}, "
                                     f"planted {planted}")

    shape = GNN_SHAPES["ogb_products"]
    N = shape["n_nodes"]
    graph = gnn_graph(N, shape["n_edges"], shape["d_feat"], args.seed,
                      device)
    dst = graph["edges"][:, 1].contiguous()
    plan = edge_chunks(dst, N)
    sizes = [c.e1 - c.e0 for c in plan]
    log(f"gnn ogb_products: {len(plan)} chunks of at most {EDGE_CHUNK} "
        f"edges (sizes {min(sizes)} to {max(sizes)}; "
        f"{sum(c.hi - c.lo == 1 and s > EDGE_CHUNK for c, s in zip(plan, sizes))}"
        f" a lone node past the cap)")
    whole: dict[int, int] = {}       # {D: launches} at the graph's shape
    chunk: dict[int, int] = {}       # ... and at chunks' shapes
    for arch in (GNN_ARCH,) + GNN_ZOO:
        cfg = gnn_config(arch, "ogb_products")
        params = gnn_init(cfg, torch.Generator(device=device)
                          .manual_seed(args.seed), device)
        res = gnn_serve(cfg, params, graph, device,
                        calls=GNN_CALLS[cfg.model], profile=True)
        want = expected_widths(cfg, 1 if cfg.model == "gcn" else len(plan))
        n_want = sum(want.values()) + (cfg.model in ("egnn", "nequip"))
        if res["launches"] != {"segment_sum_sorted": n_want}:
            raise AssertionError(f"{cfg.name} launches {res['launches']}, "
                                 f"want {n_want}")
        widths = segment_widths(cfg, params, graph)
        log(f"gnn ogb_products {cfg.name}: {json.dumps(res)}; "
            f"segment_sum_sorted launches by D in one forward "
            f"{json.dumps(widths)}")
        if widths != want:
            raise AssertionError(f"{cfg.name} launches by D {widths}, "
                                 f"want {want}")
        for d, k in widths.items():
            into = whole if cfg.model == "gcn" or d == 1 else chunk
            into[d] = into.get(d, 0) + k
        del params
        torch.cuda.empty_cache()
    for arch in GNN_ZOO[1:]:
        cfg = gnn_config(arch, "molecule")
        mol = gnn_molecule_latency(cfg, args.seed, device, calls=20)
        log(f"gnn molecule {arch}: {json.dumps(mol)}")
        n_want = sum(expected_widths(cfg, 1).values()) + 1
        if mol["launches"] != {"segment_sum_sorted": n_want}:
            raise AssertionError(f"{arch} molecule launches "
                                 f"{mol['launches']}, want {n_want}")
    del graph
    torch.cuda.empty_cache()

    rows = segment_kernel_rows(dst, N, whole, hbm)
    gen = torch.Generator(device=device).manual_seed(18)
    hub = max(plan, key=lambda c: c.e1 - c.e0)
    exact = segment_exact(dst[hub.e0:hub.e1] - hub.lo, hub.hi - hub.lo,
                          max(chunk), gen)
    log(f"kernel segment_sum_sorted at the largest chunk (E={hub.e1 - hub.e0}"
        f" N={hub.hi - hub.lo} D={max(chunk)}): [max_abs_err, planted "
        f"max_abs_err] {exact}")
    if exact[0] != 0 or exact[1] == 0:
        raise AssertionError(f"segment_sum_sorted at the largest chunk: "
                             f"{exact}")
    mid = plan[len(plan) // 2]
    rows += segment_kernel_rows(dst[mid.e0:mid.e1] - mid.lo,
                                mid.hi - mid.lo, chunk, hbm)
    del dst
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# system phase: the paper's cloud-edge pipeline (EdgeCloudSystem)
# ---------------------------------------------------------------------------

# the mix without ``complex``: that template's pattern drops its constant,
# and its induced match passes the placement index's 20M-row cap from
# scale 100 up (a limit of the reference package too)
SYSTEM_TEMPLATES = [t for t in MIX_TEMPLATES if t != "complex"]
# the paper's §5.1 system as the quickstart builds it: 20 users, 4 edges
# (SystemParams.synthetic(seed=1)), each edge's budget 0.69 of the cloud's
# bytes (the quickstart's 400,000 of 579,360), 5 history queries a user
SYSTEM_USERS, SYSTEM_EDGES, SYSTEM_HISTORY = 20, 4, 5
SYSTEM_BUDGET_SHARE = 0.69
SYSTEM_ROUND_QUERIES = 16
POLICIES = ("cloud_only", "random", "edge_first", "greedy", "bnb")
# the quickstart's algebra texts: OPTIONAL, UNION with LIMIT, DISTINCT with
# ORDER BY, ASK
SYSTEM_ALGEBRA = [
    "SELECT ?x ?g WHERE { ?x <likes> ?p . OPTIONAL { ?p <hasGenre> ?g } }",
    "SELECT ?x ?y WHERE { { ?x <follows> ?y } UNION { ?x <likes> ?y } } "
    "LIMIT 50",
    "SELECT DISTINCT ?c WHERE { ?u <country> ?c } ORDER BY ?c",
    "ASK { ?x <subgenreOf> ?y }",
]
# a cyclic BGP (mutual follows): the one text of the round that the device
# join does not cover, so its scans take the host route's fused prescan
# (``triple_scan_many``); no history holds its pattern, so it runs at the
# cloud
SYSTEM_HOST_TEXT = "SELECT ?x ?y WHERE { ?x <follows> ?y . ?y <follows> ?x }"
# the quickstart's collaborative system: one edge holds <likes>, the other
# <hasGenre>, and the path query over both is split across them
PARTIAL_LEAVES = ("SELECT ?x ?p WHERE { ?x <likes> ?p }",
                  "SELECT ?p ?gn WHERE { ?p <hasGenre> ?gn }")
PARTIAL_TEXT = ("SELECT ?x ?gn WHERE { { ?x <likes> ?p } "
                "{ ?p <hasGenre> ?gn } }")


def system_pairs(gen) -> list[tuple[int, str]]:
    """The round's (user, text) pairs: text n goes to user n mod 20."""
    from repro_torch.rdf.generator import workload_sparql
    texts = workload_sparql(gen, SYSTEM_ROUND_QUERIES, seed=77,
                            templates=SYSTEM_TEMPLATES) + SYSTEM_ALGEBRA
    texts.append(SYSTEM_HOST_TEXT)
    return [(n % SYSTEM_USERS, t) for n, t in enumerate(texts)]


def build_system(gen, store, device, max_rows):
    """The quickstart's system on ``store`` behind one torch engine on
    ``device``, placed from the users' histories; returns the system and
    what its placement holds."""
    from repro_torch.core.cost import SystemParams
    from repro_torch.edge.system import EdgeCloudSystem
    from repro_torch.rdf.generator import workload_sparql
    from repro_torch.sparql.engine import QueryEngine, TorchBackend
    params = SystemParams.synthetic(n_users=SYSTEM_USERS,
                                    n_edges=SYSTEM_EDGES, seed=1)
    budget = int(SYSTEM_BUDGET_SHARE * store.size_bytes())
    engine = QueryEngine(backend=TorchBackend(device=device),
                         max_rows=max_rows)
    system = EdgeCloudSystem(store, gen.dictionary, params, budget,
                             engine=engine)
    history = [workload_sparql(gen, SYSTEM_HISTORY, seed=100 + n,
                               templates=SYSTEM_TEMPLATES)
               for n in range(SYSTEM_USERS)]
    system.prepare(history)
    info = {"construction_seconds": system.construction_seconds,
            "budget_bytes": budget,
            "edges": [{"patterns": len(es.index),
                       "triples": (es.store.num_triples
                                   if es.store is not None else 0),
                       "bytes": es.used_bytes()} for es in system.edges]}
    return system, info


class Oracle:
    """The numpy-backend endpoint over the system's cloud store: each
    text's table is computed once a store version and reused."""

    def __init__(self, store, dictionary, max_rows: int):
        from repro_torch.sparql.endpoint import SparqlEndpoint
        from repro_torch.sparql.engine import QueryEngine
        self.store = store
        self.ep = SparqlEndpoint(store, dictionary, result_cache_size=0,
                                 engine=QueryEngine(backend="numpy",
                                                    max_rows=max_rows))
        self._version, self._tables = None, {}

    def tables(self, texts: list[str]) -> list:
        if self.store.version != self._version:
            self._version, self._tables = self.store.version, {}
        todo = [t for t in dict.fromkeys(texts) if t not in self._tables]
        if todo:
            self._tables.update(zip(todo, self.ep.query_many(todo)))
        return [self._tables[t] for t in texts]


def check_round(label: str, rep, pairs, want) -> None:
    bad = [t for (_, t), got, w in zip(pairs, rep.results, want)
           if not same_answer(got, w)]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} of {len(pairs)} results "
                             f"differ from the numpy oracle, first: {bad[0]}")


def edge_share(rep) -> float:
    """Share of the round's queries that ran at an edge, whole or split."""
    n = max(1, len(rep.outcomes))
    return sum(v for k, v in rep.assignment_counts.items() if k != -1) / n


def staged_versions(store) -> set:
    """Versions of the flat arrays ``store`` stages (its non-empty shards
    for a sharded store)."""
    shards = getattr(store, "shards", None)
    if shards is None:
        return {store.version}
    return {sh.version for sh in shards if sh.num_triples}


def _launch_delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def system_rounds(system, ep, pairs, oracle, device) -> dict:
    """Each policy's round once cold and once warm, every result held
    against the oracle; returns each policy's times, objective, edge share,
    staging uploads and kernel launches."""
    from repro_torch.kernels import launch_counts
    backend = system.engine.backend
    want = oracle.tables([t for _, t in pairs])
    out = {}
    for policy in POLICIES:
        row = {}
        for phase in ("cold", "warm"):
            if phase == "cold":
                system.clear_engine_caches()
            u0, l0 = backend.staged_uploads, launch_counts()
            rep = ep.run_round(pairs, policy=policy, observe=False,
                               collect_results=True)
            _sync(device)
            check_round(f"{policy} {phase}", rep, pairs, want)
            row[phase] = {
                "execute_wall_seconds": rep.execute_wall_seconds,
                "schedule_ms": rep.schedule_seconds * 1e3,
                "staged_uploads": backend.staged_uploads - u0,
                "launches": _launch_delta(launch_counts(), l0)}
            if policy == "bnb":
                row[phase]["optimal"] = rep.schedule_info.get("optimal")
                row[phase]["nodes_explored"] = rep.schedule_info.get(
                    "nodes_explored")
        row.update(objective=rep.objective, edge_share=edge_share(rep),
                   assignment={str(k): v for k, v in
                               sorted(rep.assignment_counts.items())},
                   partial_queries=rep.partial_queries)
        out[policy] = row
    return out


def partial_round(gen, store, engine, oracle) -> dict:
    """The quickstart's collaborative system (§6b) on ``store``: a bnb
    round of the path query must split it across the two edges and
    assemble exactly the oracle's rows."""
    from repro_torch.core.cost import SystemParams
    from repro_torch.core.pattern import pattern_of
    from repro_torch.edge.system import EdgeCloudSystem
    from repro_torch.sparql.endpoint import SparqlEndpoint
    from repro_torch.sparql.query import parse_sparql
    params = SystemParams(
        F=np.full(2, 1.0e9), r_edge=np.full((4, 2), 75e6),
        r_cloud=np.full(4, 5e6), assoc=np.ones((4, 2), dtype=bool),
        r_backhaul=np.full(2, 1e9),          # fast edge->assembler backhaul
        F_cloud=0.05e9)                      # congested cloud compute pool
    collab = EdgeCloudSystem(store, gen.dictionary, params,
                             storage_budgets=store.size_bytes(),
                             engine=engine)
    for es, text in zip(collab.edges, PARTIAL_LEAVES):
        es.deploy(store, [pattern_of(parse_sparql(text, gen.dictionary))])
    cep = SparqlEndpoint.from_system(collab)
    pairs = [(0, PARTIAL_TEXT)]
    t0 = time.perf_counter()
    rep = cep.run_round(pairs, policy="bnb", collect_results=True)
    wall = time.perf_counter() - t0
    if rep.partial_queries != 1 or rep.partial_fallbacks:
        raise AssertionError(f"partial round: {rep.partial_queries} partial "
                             f"queries, {rep.partial_fallbacks} fallbacks; "
                             "want 1 and 0")
    check_round("partial", rep, pairs, oracle.tables([PARTIAL_TEXT]))
    return {"rows": int(rep.results[0].num_matches),
            "servers": list(rep.outcomes[0].partial_servers),
            "shipped_bytes": rep.partial_bytes_shipped,
            "execute_wall_seconds": rep.execute_wall_seconds,
            "round_seconds": wall}


def system_phase(gen, store, device, max_rows: int,
                 keep: dict | None = None) -> dict:
    """Part A: the paper's pipeline on ``store`` (history -> placement ->
    five policies' rounds -> thread overlap -> partial split), every
    result held against the numpy oracle. Raises on any failed check.
    ``keep`` receives the system, its endpoint, the round's pairs and the
    oracle for the serve phase."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sparql.endpoint import SparqlEndpoint
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system, info = build_system(gen, store, device, max_rows)
    ep = SparqlEndpoint.from_system(system)
    pairs = system_pairs(gen)
    oracle = Oracle(store, gen.dictionary, max_rows)
    t1 = time.perf_counter()
    oracle.tables([t for _, t in pairs])
    info["oracle_seconds"] = time.perf_counter() - t1

    reset_launch_counts()
    rounds = system_rounds(system, ep, pairs, oracle, device)
    launches = launch_counts()
    info["rounds"] = rounds
    info["launches"] = launches
    missing = [k for k in REPLACES if launches.get(k, 0) <= 0]
    if on_card and missing:
        raise AssertionError(f"system: kernels not launched by the rounds: "
                             f"{missing}")
    best = min(r["objective"] for r in rounds.values())
    if rounds["bnb"]["objective"] > best * (1 + 1e-12):
        raise AssertionError(f"bnb objective {rounds['bnb']['objective']} "
                             f"above another policy's {best}")
    idle = [p for p in ("edge_first", "greedy", "bnb")
            if rounds[p]["edge_share"] <= 0]
    if idle:
        raise AssertionError(f"no query ran at an edge under {idle}")
    backend = system.engine.backend
    need = staged_versions(system.cloud.store).union(
        *(staged_versions(es.store) for es in system.edges
          if es.store is not None))
    info["staged"] = {"versions": len(backend._staged),
                      "missing": sorted(need - set(backend._staged))}
    if info["staged"]["missing"]:
        raise AssertionError("the staging LRU lacks the versions "
                             f"{info['staged']['missing']} of the cloud "
                             "and the populated edges")

    if on_card:
        def cold_bnb():
            system.clear_engine_caches()
            ep.run_round(pairs, policy="bnb", observe=False,
                         collect_results=True)
        prof = device_profile(cold_bnb, track=QUERY_KERNELS, cpu=False)
        kern_ms = sum(ms for ms, _ in prof["tracked"].values())
        prof["query_kernel_share"] = kern_ms / max(prof["device_ms"], 1e-12)
        info["cold_bnb_profile"] = prof

    # overlap: the port never forks; "process" runs on threads
    want = oracle.tables([t for _, t in pairs])
    info["overlap"] = {}
    for overlap, collect in ((True, True), ("process", False)):
        system.clear_engine_caches()
        rep = ep.run_round(pairs, policy="bnb", observe=False,
                           overlap=overlap, collect_results=collect)
        children = multiprocessing.active_children()
        if rep.overlap_mode != "thread" or children:
            raise AssertionError(f"overlap={overlap!r}: mode "
                                 f"{rep.overlap_mode!r}, child processes "
                                 f"{children}; want thread, none")
        if collect:
            check_round(f"overlap={overlap!r}", rep, pairs, want)
        else:
            got = [o.n_matches for o in rep.outcomes]
            if got != [w.num_matches for w in want]:
                raise AssertionError(f"overlap={overlap!r}: row counts "
                                     "differ from the numpy oracle")
        info["overlap"][str(overlap)] = {
            "mode": rep.overlap_mode,
            "execute_wall_seconds": rep.execute_wall_seconds}

    info["partial"] = partial_round(gen, store, system.engine, oracle)
    if keep is not None:
        keep.update(system=system, ep=ep, pairs=pairs, oracle=oracle,
                    bnb_objective=rounds["bnb"]["objective"])
    if on_card:
        info["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    info["phase_seconds"] = time.perf_counter() - t0
    return info


class CommitLog:
    """Records the :class:`IngestReport` of every commit the system
    makes through ``apply_update`` / ``apply_delta``."""

    def __init__(self, system):
        self.reports: list = []
        for name in ("apply_update", "apply_delta"):
            def wrapped(*a, _fn=getattr(system, name), **kw):
                rep = _fn(*a, **kw)
                self.reports.append(rep)
                return rep
            setattr(system, name, wrapped)

    def summary(self, since: int = 0) -> list[dict]:
        return [{"kind": r.kind, "n_add": r.n_add, "n_evict": r.n_evict,
                 "new_terms": r.new_terms, "edges_updated": r.edges_updated,
                 "shipped_bytes": r.shipped_bytes,
                 "patterns_carried": r.patterns_carried,
                 "patterns_invalidated": r.patterns_invalidated,
                 "apply_seconds": r.apply_seconds}
                for r in self.reports[since:]]


def pattern_instance(pattern, dictionary, tag: str) -> list[tuple]:
    """A fresh match of ``pattern``: one new term per vertex, one triple
    per edge, as (subject, predicate, object) strings."""
    return [(f"{tag}_v{u}", dictionary.predicate(label), f"{tag}_v{v}")
            for u, v, label in pattern.edges]


def _data_block(triples) -> str:
    return " . ".join(f"<{s}> <{p}> <{o}>" for s, p, o in triples)


def ingest_phase(gen, store, device, max_rows: int,
                 keep: dict | None = None) -> dict:
    """Part B: the write path and the rebalance on ``store``. A bnb round
    observes the workload; an INSERT DATA of new terms completing a
    resident pattern's match must reach the edges holding it; a window of
    two ground updates and a DELETE WHERE must commit the two as one; a
    rebalance overlaps a greedy round. After each step a round's results
    equal the numpy oracle over the mutated cloud store."""
    import torch
    from repro_torch.core.pattern import VAR_PRED_LABEL
    from repro_torch.rdf.deltas import member_rows
    from repro_torch.sparql.endpoint import SparqlEndpoint
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system, info = build_system(gen, store, device, max_rows)
    d = gen.dictionary
    ep = SparqlEndpoint.from_system(system)
    pairs = system_pairs(gen)
    oracle = Oracle(store, d, max_rows)
    backend = system.engine.backend
    commits = CommitLog(system)
    info["steps"] = {}

    def round_(label, policy="bnb", observe=False):
        u0 = backend.staged_uploads
        rep = ep.run_round(pairs, policy=policy, observe=observe,
                           collect_results=True)
        _sync(device)
        check_round(label, rep, pairs, oracle.tables([t for _, t in pairs]))
        return {"execute_wall_seconds": rep.execute_wall_seconds,
                "staged_uploads": backend.staged_uploads - u0,
                "edge_share": edge_share(rep)}

    info["steps"]["observe"] = round_("observe", observe=True)

    # an insert of new terms that completes a resident pattern's match
    holders = {}
    for es in system.edges:
        for key, p in es._resident.items():
            if all(lab != VAR_PRED_LABEL for _, _, lab in p.edges):
                holders.setdefault(key, (p, []))[1].append(es)
    if not holders:
        raise AssertionError("no edge holds a pattern of bound predicates")
    pat, edges = max(holders.values(), key=lambda pe: len(pe[1]))
    rows_a = pattern_instance(pat, d, "ingestA")
    t1 = time.perf_counter()
    ack = ep.update(f"INSERT DATA {{ {_data_block(rows_a)} }}")
    ack["seconds"] = time.perf_counter() - t1
    if not (ack["edges_updated"] > 0 and ack["new_terms"] > 0
            and ack["inserted"] == len(rows_a)):
        raise AssertionError(f"insert completing a resident match: {ack}")
    ids = np.array([[d.entity_id(s), d.predicate_id(p), d.entity_id(o)]
                    for s, p, o in rows_a], dtype=np.int64)
    for es in edges:
        if not member_rows(ids, es.store.triples()).all():
            raise AssertionError(f"edge {es.server_id} holds the resident "
                                 "pattern but not the inserted rows")
    info["steps"]["insert"] = {"ack": ack, "pattern_edges": len(pat.edges),
                               "holders": [es.server_id for es in edges],
                               "commits": commits.summary()}
    info["steps"]["insert"]["round"] = round_("after insert")

    # one window: two ground updates coalesce into one commit, then a
    # DELETE WHERE commits on its own
    rows_b = pattern_instance(pat, d, "ingestB")
    s_b, p_b, _ = rows_b[0]
    window = [f"INSERT DATA {{ {_data_block(rows_b)} }}",
              f"DELETE DATA {{ {_data_block(rows_a[:1])} }}",
              f"DELETE WHERE {{ <{s_b}> <{p_b}> ?o }}"]
    n0, w0 = len(commits.reports), ep.write_commits
    t1 = time.perf_counter()
    acks = ep.update_many(window)
    seconds = time.perf_counter() - t1
    failed = [a for a in acks if isinstance(a, Exception)]
    if failed:
        raise failed[0]
    if ([a["coalesced"] for a in acks] != [2, 2, 1]
            or ep.write_commits - w0 != 2 or len(commits.reports) - n0 != 2
            or acks[1]["deleted"] != 1 or acks[2]["deleted"] < 1):
        raise AssertionError(f"update_many window: acks {acks}, "
                             f"{ep.write_commits - w0} commits; want "
                             "coalesced [2, 2, 1] in 2 commits")
    info["steps"]["window"] = {"acks": acks, "seconds": seconds,
                               "commits": commits.summary(n0)}
    info["steps"]["window"]["round"] = round_("after window")

    # a rebalance overlapping a greedy round, then a round on its result
    t1 = time.perf_counter()
    handle = system.rebalance_async()
    info["steps"]["rebalance_overlap"] = round_("rebalance overlap",
                                                policy="greedy")
    rb = handle.join()
    info["steps"]["rebalance"] = {
        "seconds": time.perf_counter() - t1,
        "changes": {str(k): v for k, v in rb.changes.items()},
        "shipped_bytes": rb.shipped_bytes, "full_bytes": rb.full_bytes,
        "matcher_calls": rb.matcher_calls, "induced_hits": rb.induced_hits,
        "compute_seconds": rb.compute_seconds,
        "commit_seconds": rb.commit_seconds, "epoch": rb.epoch}
    info["steps"]["after_rebalance"] = round_("after rebalance")
    if keep is not None:
        keep.update(system=system, ep=ep, oracle=oracle)
    info["staged_slots"] = {"max_staged": backend.max_staged,
                            "flat_arrays": len(staged_versions(
                                system.cloud.store).union(*(
                                    staged_versions(es.store)
                                    for es in system.edges
                                    if es.store is not None)))}
    if on_card:
        info["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    info["phase_seconds"] = time.perf_counter() - t0
    return info


# ---------------------------------------------------------------------------
# the serving front end (R-QAD on the card, the pool, admission, HTTP,
# workload replay)
# ---------------------------------------------------------------------------

QAD_SOURCE = "src/repro_torch/csrc/qad_kernels.cu"
# qad_solve replaces no pl.pallas_call: the reference's jitted XLA solve
QAD_REPLACES = "src/repro/core/qad.py:96 (solve_rqad; solve_rqad_batch at " \
               ":146; jitted XLA, no pl.pallas_call)"
QAD_ITERS = 200              # B&B's solver_iters
# kernel vs plain: D within QAD_TOL plus what one ulp of A moves the plain
# version (the relaxation's own float32 conditioning); f and lb within
# QAD_TOL * max(1, |f|)
QAD_TOL = 1e-5
# seeded instances beside the round's: (N, K, children, seed); K = 18
# takes the generic route, the others the register route (two warps a
# child at 33 and 64 rows)
QAD_SEEDED = [(8, 2, 1, 1), (33, 5, 4, 2), (64, 8, 6, 3), (24, 18, 3, 5)]
QAD_ROUTES = ("register", "generic")
FADD_CYCLES = 4              # latency of a dependent float add (Hopper)
SERVE_CLIENTS_POOL, SERVE_CLIENTS_ROUND = 32, 16
SERVE_ROUND_WINDOW_S = 0.05
SERVE_WRITE_WINDOW_S = 1.0   # all six requests of the write window in one
# the workload harness as benchmarks/bench_workload.py samples it
WORKLOAD_PER_SHAPE = 4
WORKLOAD_TRAFFIC = dict(duration_s=3.0, qps=100.0, zipf_s=1.2,
                        cold_fraction=0.15, seed=1)
# row cap of the replay's oracle and engine: unanchored sampled shapes
# reach millions of rows at scale 1000 (4.05M at scale 100)
WORKLOAD_MAX_ROWS = 50_000_000


def serve_texts(gen) -> list[str]:
    """Texts whose answers stay small at scale 1000: the mix's anchored
    chains and stars, the quickstart's ASK and DISTINCT, the cyclic text of
    the host route."""
    from repro_torch.rdf.generator import workload_sparql
    return (workload_sparql(gen, 3, seed=3, templates=["anchored_chain"])
            + workload_sparql(gen, 2, seed=3, templates=["anchored_star"])
            + [SYSTEM_ALGEBRA[3], SYSTEM_ALGEBRA[2], SYSTEM_HOST_TEXT])


def qad_instance(N, K, B, seed):
    """A seeded instance of the relaxation (``make_instance``'s recipe of
    the scheduler tests) with a frontier of B children pinned to seeded
    prefixes of a third of the rows, as float32 host arrays."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(1e7, 5e8, N)
    w = rng.uniform(1e5, 5e7, N)
    e = (rng.random((N, K)) < 0.7).astype(np.float64)
    A = e * np.sqrt(c)[:, None]
    b = e * (w[:, None] / rng.uniform(2e6, 8e7, (N, K)) - w[:, None] / 5e6)
    F = rng.uniform(1e8, 1e9, K)
    fm = np.zeros(N)
    fm[:max(1, N // 3)] = 1.0
    Ds = np.zeros((B, N, K))
    for i in range(B):
        for n in range(max(1, N // 3)):
            feas = np.flatnonzero(e[n])
            ch = rng.integers(-1, len(feas))
            if ch >= 0:
                Ds[i, n, feas[ch]] = 1.0
    return [x.astype(np.float32) for x in (A, b, F, e, fm, Ds)]


class FrontierLog:
    """Records each expansion's R-QAD inputs while B&B runs (a wrapper on
    ``RqadBounder.solve``)."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        from repro_torch.core import qad
        self._cls, self._real = qad.RqadBounder, qad.RqadBounder.solve
        log_ = self

        def solve(bounder, fixed_mask, fixed_Ds, iters):
            log_.calls.append(([t.cpu().numpy() for t in bounder._arrays],
                               np.asarray(fixed_mask, np.float32),
                               np.asarray(fixed_Ds, np.float32)))
            return log_._real(bounder, fixed_mask, fixed_Ds, iters)
        self._cls.solve = solve
        return self

    def __exit__(self, *exc):
        self._cls.solve = self._real


def qad_compare(args, device, iters=QAD_ITERS) -> dict:
    """The kernel against the plain version on the card (both float32) on
    one instance; raises past the tolerance."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.qad_solve import qad_plan, qad_solve, unpack
    A, b, F, e, fm, Ds = (torch.from_numpy(np.ascontiguousarray(x))
                          .to(device) for x in args)
    N, K = A.shape
    got = unpack(qad_solve(A, b, F, e, fm, Ds, iters).cpu(), N, K)
    plain = unpack(ref.qad_solve_reference(A, b, F, e, fm, Ds, iters)
                   .cpu(), N, K)
    nudged = unpack(ref.qad_solve_reference(
        A * (1 + 2.0 ** -23), b, F, e, fm, Ds, iters).cpu(), N, K)
    spread = float((nudged[0] - plain[0]).abs().max())
    return {"N": N, "K": K, "B": int(Ds.shape[0]),
            "route": qad_plan(N, K).route, **qad_errors(got, plain, spread)}


def qad_errors(got, plain, spread: float) -> dict:
    D, f, lb = got
    pD, pf, plb = plain
    scale = pf.abs().clamp_min(1.0)
    out = {"d_err": float((D - pD).abs().max()),
           "f_err": float(((f - pf).abs() / scale).max()),
           "lb_err": float(((lb - plb).abs() / scale).max()),
           "d_tol": QAD_TOL + spread}
    out["ok"] = bool(out["d_err"] <= out["d_tol"]
                     and out["f_err"] <= QAD_TOL
                     and out["lb_err"] <= QAD_TOL)
    return out


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def qad_kernel_row(args, launches: int, err: float, hbm: float) -> dict:
    """``qad_solve`` at the round's shape: its time (events over 10
    back-to-back solves, median of 7), the profiler's device time a launch,
    the plain version's time on the card, and its bound: the larger of the
    bytes over the memory rate, the float operations over the float32 peak
    and the dependency chain (a row's 40 bisection steps, K dependent adds
    each, every Nesterov step, at the card's top SM clock). ``bound_by``
    names the kind of the largest part (the chain is one of dependent
    operations), ``bound_part`` the part itself."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.qad_solve import qad_plan, qad_solve
    dev = torch.device("cuda")
    A, b, F, e, fm, Ds = (torch.from_numpy(np.ascontiguousarray(x))
                          .to(dev) for x in args)
    B, N, K = Ds.shape
    plan = qad_plan(N, K)

    def solve():
        return qad_solve(A, b, F, e, fm, Ds, QAD_ITERS)
    kern_ms = time_ms(solve, calls=10)
    device_ms, recorded = kernel_device_ms(
        solve, "qad_reg_kernel" if plan.route == "register"
        else "qad_solve_kernel")
    plain_ms = time_ms(lambda: ref.qad_solve_reference(
        A, b, F, e, fm, Ds, QAD_ITERS), calls=1, reps=3)
    nbytes = 4 * (3 * N * K + K + N + B * N * K + B * (N * K + 2))
    flops = B * QAD_ITERS * N * K * (ref.QAD_BISECT * 3 + 12)
    chain = QAD_ITERS * ref.QAD_BISECT * K * FADD_CYCLES / sm_clock_hz()
    bounds = {"bytes": nbytes / hbm * 1e3,
              "operations": flops / SCALAR_OPS_PER_S * 1e3,
              "chain": chain * 1e3}
    part = max(bounds, key=bounds.get)
    return {"name": "qad_solve", "route": "cuda", "source": QAD_SOURCE,
            "replaces": QAD_REPLACES, "pallas_counterpart": None,
            "launches": int(launches), "max_abs_err": err, "ms": kern_ms,
            "device_ms": device_ms, "device_launches": recorded,
            "plain_ms": plain_ms, "bound_ms": bounds[part],
            "bound_by": "bytes" if part == "bytes" else "operations",
            "bound_part": part, "bound_parts_ms": bounds,
            "shape": {"B": B, "N": N, "K": K, "iters": QAD_ITERS},
            "qad_route": plan.route, "library_ms": None}


def check_bnb(rq, mg, launches: int | None) -> None:
    """B&B with the R-QAD bound against the marginal bound on one
    instance: both certified, same objective and D, one kernel launch an
    expansion (``launches`` None on the CPU, which launches none)."""
    if not (rq.optimal and mg.optimal):
        raise AssertionError(f"bnb not certified: rqad {rq.optimal}, "
                             f"marginal {mg.optimal}")
    if not math.isclose(rq.objective, mg.objective, rel_tol=1e-9):
        raise AssertionError(f"bnb objectives differ: rqad {rq.objective}, "
                             f"marginal {mg.objective}")
    if not np.array_equal(rq.D, mg.D):
        raise AssertionError("bnb: rqad and marginal assignments differ")
    if launches is not None and launches != rq.nodes_explored:
        raise AssertionError(f"qad_solve launched {launches} times for "
                             f"{rq.nodes_explored} expansions")


def must_fail(label: str, check, *a) -> None:
    """A planted fault must fail ``check``."""
    try:
        check(*a)
    except AssertionError:
        return
    raise AssertionError(f"{label}: the planted fault passed the check")


def rqad_checks(kept: dict, device, hbm: float) -> tuple[dict, dict]:
    """Checks 1 and 2: the kernel against its plain version on the cold
    bnb round's own instance and on seeded ones; B&B on that instance with
    both bounds."""
    import torch
    from repro_torch.core.bnb import branch_and_bound
    from repro_torch.kernels import launch_counts, reset_launch_counts
    on_card = torch.device(device).type == "cuda"
    system, ep, pairs = kept["system"], kept["ep"], kept["pairs"]
    queries = [(u, ep.parse(t)) for u, t in pairs]
    with FrontierLog() as frontiers:
        tasks, params, _, _ = system._schedule_round(
            queries, "bnb", {"bound": "rqad", "device": device},
            include_partial=True)
    calls = frontiers.calls
    if not calls:
        raise AssertionError("the round's B&B bounded no frontier")
    widest = max(range(len(calls)), key=lambda i: len(calls[i][2]))
    picks = sorted({0, widest, len(calls) - 1})
    cases = [("round", [*calls[i][0], calls[i][1], calls[i][2]])
             for i in picks]
    cases += [(f"seeded{N}x{K}", qad_instance(N, K, B, seed))
              for N, K, B, seed in QAD_SEEDED]
    rows = []
    for label, args in cases:
        r = qad_compare(args, device)
        r["case"] = label
        rows.append(r)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"qad_solve differs from its plain version: "
                             f"{bad}")
    if {r["route"] for r in rows} != set(QAD_ROUTES):
        raise AssertionError(f"qad_solve: the cases did not take both "
                             f"routes: {[r['route'] for r in rows]}")
    # planted fault: a kernel that ignores the pinned rows
    from repro_torch.kernels import ref
    from repro_torch.kernels.qad_solve import qad_solve, unpack
    round_args = [*calls[widest][0], calls[widest][1], calls[widest][2]]
    A, b, F, e, fm, Ds = (torch.from_numpy(np.ascontiguousarray(x))
                          .to(device) for x in round_args)
    N, K = A.shape
    kern = unpack(qad_solve(A, b, F, e, fm, Ds, QAD_ITERS).cpu(), N, K)
    unpinned = unpack(ref.qad_solve_reference(
        A, b, F, e, torch.zeros_like(fm), Ds, QAD_ITERS).cpu(), N, K)
    planted = qad_errors(kern, unpinned, 0.0)
    if planted["ok"]:
        raise AssertionError("qad_solve: the planted fault (pins dropped) "
                             "passed the check")
    check1 = {"cases": rows, "planted": planted, "expansions": len(calls),
              "widest": int(len(calls[widest][2])), "N": int(N),
              "K": int(K),
              "row": (qad_kernel_row(round_args, 0,
                                     max(r["d_err"] for r in rows), hbm)
                      if on_card else None)}

    # check 2: B&B on the card with both bounds
    times = {"rqad": [], "marginal": []}
    for _ in range(3 if on_card else 1):
        reset_launch_counts()
        t0 = time.perf_counter()
        rq = branch_and_bound(tasks, params, bound="rqad", device=device)
        _sync(device)
        times["rqad"].append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
        launches = counts.get("qad_solve", 0) if on_card else None
        t0 = time.perf_counter()
        mg = branch_and_bound(tasks, params, bound="marginal")
        times["marginal"].append((time.perf_counter() - t0) * 1e3)
        check_bnb(rq, mg, launches)
    cut = branch_and_bound(tasks, params, bound="rqad", device=device,
                           max_nodes=1)
    must_fail("bnb", check_bnb, cut, mg, launches)
    check2 = {"nodes_explored": {"rqad": rq.nodes_explored,
                                 "marginal": mg.nodes_explored},
              "nodes_pruned": {"rqad": rq.nodes_pruned,
                               "marginal": mg.nodes_pruned},
              "schedule_ms": {k: statistics.median(v)
                              for k, v in times.items()},
              "qad_solve_launches": launches,
              "qad_solve_launches_by_route": {
                  r: counts.get(f"qad_solve/{r}", 0) for r in QAD_ROUTES},
              "objective": rq.objective,
              "N": tasks.N, "K": params.K}
    return check1, check2


def http_request(url: str, text: str, how: str, user: int = 0):
    """One SPARQL request (GET, a raw POST or a form POST); returns the
    JSON body and the seconds it took."""
    import urllib.request
    from urllib.parse import urlencode
    t0 = time.perf_counter()
    if how == "get":
        req = urllib.request.Request(
            f"{url}/sparql?{urlencode({'query': text, 'user': user})}")
    elif how == "raw":
        req = urllib.request.Request(
            f"{url}/sparql?{urlencode({'user': user})}", data=text.encode(),
            headers={"Content-Type": "application/sparql-query"})
    else:
        req = urllib.request.Request(
            f"{url}/sparql", data=urlencode({"query": text, "user": user})
            .encode(), headers={
                "Content-Type": "application/x-www-form-urlencoded"})
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    return body, time.perf_counter() - t0


def json_answer(table, text: str, dictionary) -> dict:
    """The W3C JSON of ``table`` as the port's serializer writes it."""
    from repro_torch.runtime.http import ask_to_json, table_to_json
    from repro_torch.sparql.algebra import AskNode, compile_query
    from repro_torch.sparql.query import parse_query
    plan = compile_query(parse_query(text, dictionary), dictionary)
    return ask_to_json(table) if isinstance(plan, AskNode) \
        else table_to_json(table)


def same_json(a: dict, b: dict) -> bool:
    """Equal heads, and bindings equal as multisets."""
    if a.get("head") != b.get("head") or a.get("boolean") != \
            b.get("boolean"):
        return False
    def rows(x):
        return sorted(json.dumps(r, sort_keys=True)
                      for r in x.get("results", {}).get("bindings", []))
    return rows(a) == rows(b)


def check_json(label: str, bodies: list, want: list) -> None:
    bad = sum(not same_json(g, w) for g, w in zip(bodies, want))
    if bad or len(bodies) != len(want):
        raise AssertionError(f"{label}: {bad} of {len(want)} HTTP answers "
                             "differ from the numpy oracle's")


def clients(url: str, jobs: list) -> tuple[list, list]:
    """Runs each (text, how, user) job on its own thread, all released
    together; returns the bodies and the seconds each took."""
    import threading
    out: list = [None] * len(jobs)
    gate = threading.Barrier(len(jobs))
    errors: list = []

    def run(i, job):
        try:
            gate.wait(60)
            out[i] = http_request(url, *job)
        except Exception as err:          # surfaced below
            errors.append(err)
    threads = [threading.Thread(target=run, args=(i, j))
               for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors:
        raise errors[0]
    return [o[0] for o in out], [o[1] for o in out]


def latency(secs: list) -> dict:
    return {"p50_ms": float(np.percentile(secs, 50) * 1e3),
            "p99_ms": float(np.percentile(secs, 99) * 1e3)}


def http_pool(gen, store, oracle, device, max_rows: int) -> tuple:
    """Check 4: the pool front end as ``examples/serve_offload.py`` lays it
    out, over HTTP."""
    from repro_torch.runtime.http import SparqlHttpServer
    from repro_torch.runtime.serving import (OffloadServingPool, Replica,
                                             make_sparql_runner)
    from repro_torch.sparql.endpoint import SparqlEndpoint
    from repro_torch.sparql.engine import QueryEngine, TorchBackend
    engine = QueryEngine(backend=TorchBackend(device=device),
                         max_rows=max_rows)
    runner = make_sparql_runner(store, engine)
    pool = OffloadServingPool(
        replicas=[Replica(0, {0}, 2e8, 75e6, runner),
                  Replica(1, {0}, 4e8, 75e6, runner)],
        cloud_runner=runner, cloud_link_bps=5e6)
    ep = SparqlEndpoint(store, gen.dictionary, engine=engine, pool=pool)
    texts = serve_texts(gen)
    want = [json_answer(t, x, gen.dictionary)
            for t, x in zip(oracle.tables(texts), texts)]
    hows = ("get", "raw", "form")
    jobs = [(texts[i % len(texts)], hows[i % 3], 0)
            for i in range(SERVE_CLIENTS_POOL)]
    t0 = time.perf_counter()
    with SparqlHttpServer(ep, mode="pool", window_s=0.002, max_batch=64,
                          mode_kw={"policy": "greedy"}) as srv:
        bodies, secs = clients(srv.url, jobs)
        wall = time.perf_counter() - t0
        stats = srv.stats_dict()
    expect = [want[i % len(texts)] for i in range(len(jobs))]
    check_json("http pool", bodies, expect)
    must_fail("http pool", check_json, "planted", bodies,
              expect[1:] + expect[:1])
    adm = stats["admission"]
    if not adm["batches"] < adm["submitted"]:
        raise AssertionError(f"http pool: {adm['batches']} batches for "
                             f"{adm['submitted']} requests")
    return {
        "wall_s": wall, **latency(secs), "batches": adm["batches"],
        "submitted": adm["submitted"],
        "mean_batch_size": adm["mean_batch_size"],
        "assignment_counts": adm["assignment_counts"],
        "rows": [len(b.get("results", {}).get("bindings", []))
                 for b in want]}


def check_windows(label: str, infos: list) -> None:
    if not infos or not all(i.get("optimal") for i in infos):
        raise AssertionError(f"{label}: B&B not certified in every window: "
                             f"{infos}")


def http_round(gen, kept: dict, device) -> dict:
    """Check 5: the round front end over the scale-1000 system, B&B on the
    R-QAD bound in every window."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.runtime.http import SparqlHttpServer
    ep, oracle = kept["ep"], kept["oracle"]
    budget = ({} if torch.device(device).type == "cuda"
              else {"max_seconds": None})
    infos: list = []
    real = ep.run_round

    def run_round(*a, **kw):
        rep = real(*a, **kw)
        infos.append(dict(rep.schedule_info))
        return rep
    ep.run_round = run_round
    texts = serve_texts(gen)
    want = [json_answer(t, x, gen.dictionary)
            for t, x in zip(oracle.tables(texts), texts)]
    jobs = [(texts[i % len(texts)], ("get", "raw", "form")[i % 3],
             i % SYSTEM_USERS) for i in range(SERVE_CLIENTS_ROUND)]
    l0 = launch_counts().get("qad_solve", 0)
    try:
        t0 = time.perf_counter()
        with SparqlHttpServer(ep, mode="round",
                              window_s=SERVE_ROUND_WINDOW_S, max_batch=32,
                              mode_kw={"policy": "bnb", "bound": "rqad",
                                       **budget}) as srv:
            bodies, secs = clients(srv.url, jobs)
            wall = time.perf_counter() - t0
            stats = srv.stats_dict()
    finally:
        del ep.run_round
    expect = [want[i % len(texts)] for i in range(len(jobs))]
    check_json("http round", bodies, expect)
    must_fail("http round", check_json, "planted", bodies,
              expect[1:] + expect[:1])
    check_windows("http round", infos)
    must_fail("http round", check_windows, "planted",
              infos + [{"optimal": False}])
    qad = launch_counts().get("qad_solve", 0) - l0
    if qad <= 0 and torch.device(device).type == "cuda":
        raise AssertionError("http round: B&B ran without qad_solve")
    return {"wall_s": wall, **latency(secs),
            "batches": stats["admission"]["batches"],
            "mean_batch_size": stats["admission"]["mean_batch_size"],
            "windows": [{k: i.get(k) for k in ("nodes_explored",
                                                "optimal", "solve_seconds")}
                        for i in infos],
            "qad_solve_launches": qad}


def write_window(small, kept: dict) -> dict:
    """Check 6: four reads and two INSERT DATA POSTs to ``/update`` in one
    window of the ingest system's round front end."""
    import threading
    import urllib.request
    from repro_torch.runtime.http import SparqlHttpServer
    ep, oracle, d = kept["ep"], kept["oracle"], small.dictionary
    store = kept["system"].cloud.store
    pid = d.predicate_id("likes")
    idx = store.pred_index(pid)
    user = d.entity(int(store.s[idx.s_order[0]]))
    mine = f"SELECT ?p WHERE {{ <{user}> <likes> ?p }}"
    texts = [mine, f"ASK {{ <{user}> <likes> ?p }}"] + serve_texts(small)[:2]
    writes = [f"INSERT DATA {{ <{user}> <likes> <serveW{i}> }}"
              for i in range(2)]
    before = [json_answer(t, x, d)
              for t, x in zip(oracle.tables(texts), texts)]
    out: dict = {}
    gate = threading.Barrier(len(texts) + len(writes))

    def read(i):
        gate.wait(60)
        out[("r", i)] = http_request(srv.url, texts[i], "get")[0]

    def write(i):
        gate.wait(60)
        req = urllib.request.Request(
            f"{srv.url}/update", data=writes[i].encode(),
            headers={"Content-Type": "application/sparql-update"})
        with urllib.request.urlopen(req, timeout=600) as r:
            out[("w", i)] = json.loads(r.read())

    commits0 = ep.write_commits
    with SparqlHttpServer(ep, mode="round", coalesce_writes=True,
                          window_s=SERVE_WRITE_WINDOW_S, max_batch=64) as srv:
        threads = ([threading.Thread(target=read, args=(i,))
                    for i in range(len(texts))]
                   + [threading.Thread(target=write, args=(i,))
                      for i in range(len(writes))])
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        batches = srv.queue.stats.batches
        after = http_request(srv.url, mine, "get")[0]
    reads = [out[("r", i)] for i in range(len(texts))]
    acks = [out[("w", i)] for i in range(len(writes))]
    check_json("write window reads", reads, before)
    want_after = json_answer(oracle.tables([mine])[0], mine, d)
    check_json("read after the window", [after], [want_after])
    must_fail("write window", check_json, "planted", reads[:1],
              [want_after])
    if (batches != 1 or [a["coalesced"] for a in acks] != [2, 2]
            or [a["inserted"] for a in acks] != [1, 1]
            or ep.write_commits - commits0 != 1):
        raise AssertionError(f"write window: {batches} batches, acks {acks},"
                             f" {ep.write_commits - commits0} commits; want "
                             "one window, both coalesced in 1 commit")
    got_rows = len(after["results"]["bindings"])
    if got_rows != len(before[0]["results"]["bindings"]) + 2:
        raise AssertionError("the read after the window misses the inserts")
    return {"wall_s": wall, "acks": acks, "commits": 1,
            "rows_before": len(before[0]["results"]["bindings"]),
            "rows_after": got_rows}


def check_replay(label: str, rep, sched) -> None:
    if not (rep.verification_ok and rep.errors == 0
            and rep.completed == len(sched.events)
            and rep.verified == sched.n_queries):
        raise AssertionError(f"{label}: completed {rep.completed} of "
                             f"{len(sched.events)}, errors {rep.errors}, "
                             f"verified {rep.verified}, mismatches "
                             f"{rep.mismatches}")


def workload_replay(gen, store, device) -> dict:
    """Check 7: sampled templates replayed through the endpoint's
    admission queue on the card, every answer checked against the
    cardinality the sampler's numpy oracle recorded."""
    from repro_torch.runtime.admission import AdmissionQueue
    from repro_torch.sparql.endpoint import SparqlEndpoint
    from repro_torch.sparql.engine import QueryEngine, TorchBackend
    from repro_torch.workload import (PatternSampler, Schedule,
                                      ShapeConfig, TrafficConfig,
                                      build_schedule, replay)
    from repro_torch.workload.sampler import SHAPES
    t0 = time.perf_counter()
    smp = PatternSampler(store, gen.dictionary, seed=0,
                         exclude_predicates=["country"],
                         engine=QueryEngine(backend="numpy",
                                            max_rows=WORKLOAD_MAX_ROWS))
    templates = smp.sample_mix(
        [ShapeConfig(s, size=3, const_frac=0.3,
                     decorations=(None, "filter", "limit"))
         for s in SHAPES], WORKLOAD_PER_SHAPE)
    sample_s = time.perf_counter() - t0
    sched = build_schedule(templates, TrafficConfig(**WORKLOAD_TRAFFIC))
    ep = SparqlEndpoint(store, gen.dictionary, engine=QueryEngine(
        backend=TorchBackend(device=device), max_rows=WORKLOAD_MAX_ROWS))
    with AdmissionQueue(ep, mode="endpoint", window_s=0.002,
                        max_batch=64) as q:
        rep = replay(q, sched)
        check_replay("workload replay", rep, sched)
        wrong = [dataclasses.replace(e, cardinality=e.cardinality + 1)
                 for e in sched.events[:20]]
        bad = Schedule(events=wrong, config=sched.config,
                       templates=sched.templates)
        must_fail("workload replay", check_replay, "planted",
                  replay(q, bad, speed=100.0), bad)
    return {"sample_s": sample_s, "templates": [
                {"shape": t.shape, "cardinality": t.cardinality,
                 "decoration": t.decoration} for t in templates],
            "events": len(sched.events), "completed": rep.completed,
            "errors": rep.errors, "verified": rep.verified,
            "wall_s": rep.wall_s,
            "per_shape": {k: {"count": v.count,
                              **{p: v.percentiles()[p] * 1e3
                                 for p in ("p50", "p99")}}
                          for k, v in sorted(rep.per_shape.items())},
            "batches": rep.admission["batches"],
            "mean_batch_size": rep.admission["mean_batch_size"]}


def serve_phase(gen, small, kept_a: dict, kept_b: dict, device,
                max_rows: int, hbm: float) -> tuple[dict, dict]:
    """The serving front end on the card: the R-QAD kernel against its
    plain version, B&B with both bounds, a bnb round on the R-QAD bound,
    HTTP in pool and round modes, a write window, a workload replay.
    Returns the phase's info and the ``qad_solve`` kernel row."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    info: dict = {}
    info["qad"], info["bnb"] = rqad_checks(kept_a, device, hbm)
    row = info["qad"].pop("row")

    # the main path, through the entry points a user calls
    reset_launch_counts()
    ep, pairs, oracle = kept_a["ep"], kept_a["pairs"], kept_a["oracle"]
    kept_a["system"].clear_engine_caches()
    t1 = time.perf_counter()
    # the system's 2-s B&B budget on the card; the plain version on the
    # CPU (a rehearsal) takes ~0.3 s a solve, so there B&B runs unbudgeted
    budget = {} if on_card else {"max_seconds": None}
    rep = ep.run_round(pairs, policy="bnb", bound="rqad", observe=False,
                       collect_results=True, **budget)
    _sync(device)
    want = oracle.tables([t for _, t in pairs])
    check_round("bnb round (rqad)", rep, pairs, want)
    must_fail("bnb round (rqad)", check_round, "planted", rep, pairs,
              want[1:] + want[:1])
    if not (rep.schedule_info.get("optimal") and math.isclose(
            rep.objective, kept_a["bnb_objective"], rel_tol=1e-9)):
        raise AssertionError(f"bnb round (rqad): objective {rep.objective} "
                             f"against the marginal round's "
                             f"{kept_a['bnb_objective']}, info "
                             f"{rep.schedule_info}")
    info["round"] = {"seconds": time.perf_counter() - t1,
                     "execute_wall_seconds": rep.execute_wall_seconds,
                     "schedule_ms": rep.schedule_seconds * 1e3,
                     "objective": rep.objective,
                     "nodes_explored": rep.schedule_info.get(
                         "nodes_explored")}
    info["http_pool"] = http_pool(gen, gen.store, oracle, device, max_rows)
    info["http_round"] = http_round(gen, kept_a, device)
    info["write_window"] = write_window(small, kept_b)
    info["workload"] = workload_replay(gen, gen.store, device)
    launches = launch_counts()
    info["launches"] = launches
    missing = [k for k in [*REPLACES, "qad_solve"]
               if launches.get(k, 0) <= 0]
    if row is not None:
        if missing:
            raise AssertionError(f"serve: kernels not launched on the "
                                 f"serving path: {missing}")
        row["launches"] = int(launches["qad_solve"])
        row["launches_by_route"] = {
            r: int(launches.get(f"qad_solve/{r}", 0)) for r in QAD_ROUTES}
    info["phase_seconds"] = time.perf_counter() - t0
    return info, row


def log_serve(info: dict, gpu: str) -> None:
    q = info["qad"]
    log(f"serve qad_solve vs plain on {gpu}: {q['expansions']} expansions "
        f"of the round (N {q['N']}, K {q['K']}, widest {q['widest']}); "
        f"{json.dumps(q['cases'])}; planted {json.dumps(q['planted'])}")
    log(f"serve bnb on {gpu}: {json.dumps(info['bnb'])}")
    log(f"serve bnb round rqad on {gpu}: {json.dumps(info['round'])}")
    for key in ("http_pool", "http_round", "write_window", "workload"):
        log(f"serve {key} on {gpu}: {json.dumps(info[key])}")
    log(f"serve launches on the serving path: {json.dumps(info['launches'])}"
        f"; phase {info['phase_seconds']} s")


def log_system(info: dict, gpu: str) -> None:
    """The system phase's lines: placement, each policy's cold and warm
    round, the cold bnb round's device time, overlap and the partial
    round."""
    log(f"system placement on {gpu}: construction_seconds "
        f"{info['construction_seconds']}, budget {info['budget_bytes']} B, "
        f"edges {json.dumps(info['edges'])}, oracle "
        f"{info['oracle_seconds']} s")
    for policy, r in info["rounds"].items():
        log(f"system round {policy} on {gpu}: cold "
            f"{r['cold']['execute_wall_seconds']} s, warm "
            f"{r['warm']['execute_wall_seconds']} s, schedule_ms "
            f"{r['cold']['schedule_ms']}, objective {r['objective']}, "
            f"edge_share {r['edge_share']}: {json.dumps(r)}")
        if policy == "bnb" and not (r["cold"]["optimal"]
                                    and r["warm"]["optimal"]):
            log("system round bnb: B&B stopped at its budget, the "
                "incumbent is not certified optimal")
    log(f"system launches over the rounds: {json.dumps(info['launches'])}; "
        f"staged {json.dumps(info['staged'])}")
    if "cold_bnb_profile" in info:
        log(f"system cold bnb round under the profiler on {gpu}: "
            f"{json.dumps(info['cold_bnb_profile'])}")
    log(f"system overlap: {json.dumps(info['overlap'])}")
    log(f"system partial round on {gpu}: {json.dumps(info['partial'])}")
    log(f"system max_memory_allocated_gb "
        f"{info.get('max_memory_allocated_gb')}, phase "
        f"{info['phase_seconds']} s")


# ---------------------------------------------------------------------------
# training (card only, under --train-only too)
# ---------------------------------------------------------------------------

BWD_SOURCE = {"flash_attention_bwd": "src/repro_torch/csrc/flash_bwd.cu",
              "embedding_bag_bwd": SPARSE_SOURCE}
BWD_REPLACES = {
    "flash_attention_bwd": "src/repro/models/transformer.py:223 "
                           "(chunked_causal_attention, differentiated by "
                           "XLA under jax.checkpoint; no Pallas kernel)",
    "embedding_bag_bwd": "src/repro/models/recsys.py:103 (embedding_bag's "
                         "gather, differentiated by XLA; no Pallas kernel)",
}
# flash_attention_bwd against autograd of the plain version (float32
# inside, each gradient rounded once to its input's dtype), element by
# element (flash_bwd_bound): |kernel - plain| <= BWD_REL |plain| + BWD_SUM M
# + BWD_DELTA E. M sums the magnitudes of each gradient's terms (scale P
# (|dO| |V|^T + |Delta|) times |K| or |Q|, P^T |dO|): float32 sums of up to
# S terms in another order and P from the forward's lse. E is the part
# that Delta carries: the kernel takes Delta = rowsum(dO O) from the
# forward's output, rounded to bf16 (half an ulp, at most 2^-9 |O|). The
# final rounding to bf16 of both sides moves them apart by up to one ulp,
# 2^-7 |plain|; BWD_REL is twice that, BWD_DELTA twice 2^-9.
BWD_REL = {"float32": 0.0, "bfloat16": 2.0 ** -6}
BWD_DELTA = {"float32": 0.0, "bfloat16": 2.0 ** -8}
BWD_SUM = 2.0 ** -14
BWD_LATE_ERR = 1.0 / 8       # the later-rows control: dq off by 1/8
LSE_TOL = 1e-5               # the forward's lse, times max(1, |lse|)
TRAIN_SEQ = 2048             # qwen3-0.6b training: B = 8, S = 2048
TRAIN_BATCH = 8
TRAIN_STEPS = 5              # AdamW steps of each model on one batch
TRAIN_LR = 1e-3
RECSYS_TRAIN_BATCH = 65536   # RECSYS_SHAPES["train_batch"]
GRAD_CHECK_LAYERS = 2        # the f32 lm_loss step, card vs CPU
GRAD_CHECK_SEQ = 64
GRAD_TOL = 1e-4              # each gradient leaf, times max |CPU leaf|


def grad_err(got, want, tol: float) -> tuple[float, float]:
    """(max |got - want|, the largest ratio over the tensors of max |got -
    want| / (tol * max |want|)): within tolerance when at most 1."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
    err, ratio = 0.0, 0.0
    for g, w in zip(got, want):
        if not g.numel():
            continue
        d = float((g.float() - w.float()).abs().max())
        err = max(err, d)
        ratio = max(ratio, d / (tol * max(float(w.float().abs().max()),
                                          1e-30)))
    return err, ratio


def flash_bwd_bound(q, k, v, o, dout, want, window: int = 0,
                    softcap: float = 0.0) -> list:
    """The element-wise bound of |kernel - plain| for dq, dk and dv (see
    BWD_REL): BWD_REL |want| + BWD_SUM M + BWD_DELTA E, with W = P
    (|dO| |V|^T + A), A = rowsum(|dO| |O|) and, summed over each group,
    M_dq = scale W |K|, M_dk = scale W^T |Q|, M_dv = P^T |dO|, E_dq =
    scale (P A) |K|, E_dk = scale (P A)^T |Q|. The softcap's factor is at
    most 1, so it is left out. Dense over [H, S, S] one batch row at a
    time; float32."""
    import torch
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = d ** -0.5
    name = str(q.dtype).removeprefix("torch.")
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    out = [BWD_REL[name] * w.float().abs() for w in want]
    for b in range(B):
        qf, dof = q[b].float(), dout[b].float()
        kr = k[b].float().repeat_interleave(G, 0)
        vr = v[b].float().repeat_interleave(G, 0)
        x = torch.einsum("hqd,hkd->hqk", qf, kr) * scale
        if softcap > 0:
            x = torch.tanh(x / softcap) * softcap
        p = torch.softmax(x.masked_fill_(~mask, float("-inf")), dim=-1)
        del x
        a = (dof.abs() * o[b].float().abs()).sum(-1, keepdim=True)
        pa = p * a
        w = torch.einsum("hqd,hkd->hqk", dof.abs(), vr.abs()).mul_(p) \
            .add_(pa)
        ak, aq = kr.abs(), qf.abs()
        out[0][b] += scale * (BWD_SUM * (w @ ak) + BWD_DELTA[name] * (pa @ ak))
        dk = BWD_SUM * (w.transpose(1, 2) @ aq) \
            + BWD_DELTA[name] * (pa.transpose(1, 2) @ aq)
        out[1][b] += scale * dk.view(Hkv, G, S, d).sum(1)
        out[2][b] += BWD_SUM * (p.transpose(1, 2) @ dof.abs()).view(
            Hkv, G, S, d).sum(1)
        del p, pa, w
    return out


def bwd_err(got, want, bound) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / bound) over dq, dk and dv,
    element by element: within tolerance when the second is at most 1."""
    err, ratio = 0.0, 0.0
    for g, w, b in zip(got, want, bound):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {tuple(g.shape)} {g.dtype} "
                                 f"vs {tuple(w.shape)} {w.dtype}")
        if not g.numel():
            continue
        diff = (g.float() - w.float()).abs()
        err = max(err, float(diff.max()))
        ratio = max(ratio, float((diff / b.clamp(min=1e-30)).max()))
    return err, ratio


def late_rows_wrong(grads):
    """A planted fault: dq of the later half of the rows off by
    BWD_LATE_ERR, dk and dv as they are."""
    dq = grads[0].clone()
    dq[:, :, dq.shape[2] // 2:] *= 1 - BWD_LATE_ERR
    return dq, grads[1], grads[2]


def flash_bwd_math(q, k, v, o, dout, lse, window: int = 0,
                   softcap: float = 0.0, fault: str | None = None):
    """dq, dk, dv by the backward kernel's formulas (FlashAttention-2's),
    dense in float32: P = exp(s - lse) on the causal (and window) mask,
    Delta = rowsum(dO * O), dS = P (dO V^T - Delta) (1 - (s / c)^2),
    dq = scale dS K, dk = scale dS^T Q summed over each group, dv = P^T dO
    likewise. ``fault`` plants an error the checks must find:
    ``"softcap"`` leaves out the softcap's factor, ``"delta"`` Delta.
    Small S only (dense [B, H, S, S])."""
    import torch
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    kr, vr = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    factor = None
    if softcap > 0:
        t = torch.tanh(x / softcap)
        x, factor = t * softcap, 1 - t * t
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.where(mask, torch.exp(x - lse[..., None]), 0.0)
    dof = dout.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - (0.0 if fault == "delta" else delta))
    if factor is not None and fault != "softcap":
        ds = ds * factor
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf).view(
        B, Hkv, G, S, d).sum(2) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).view(B, Hkv, G, S, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bag_bwd_bound(g, ids, mask, n_rows, combiner):
    """SUM_GROWTH * (entries adding into the row) * sum of |g w| per row
    and column: the order-of-summation bound of the atomics."""
    import torch
    from repro_torch.kernels import ref
    live = (mask != 0).reshape(-1).float()
    per_row = torch.zeros(n_rows, device=g.device).index_add_(
        0, ids.reshape(-1).long(), live)
    return SUM_GROWTH * per_row[:, None] * ref.embedding_bag_backward_reference(
        g.abs().float(), ids, mask.abs(), n_rows, combiner)


def check_backward_cases(dev, dtypes=("float32", "bfloat16")) -> dict:
    """Both backward kernels against their plain versions on the card.
    ``flash_attention_bwd`` (from the forward kernel's own output and row
    lse, themselves checked) against autograd of ``mha_reference``: ragged
    S, windows on and off, softcaps on and off, GQA groups of 1, 2 and 4,
    d 64, 128 and 256 (and 16, 32), strided and contiguous layouts, element
    by element within ``flash_bwd_bound``; each case also reads a planted
    fault (the kernel's formulas with the softcap's factor left out, or
    Delta where there is no softcap) and, from S = 64 on with a window
    other than 1, a second one (``late_rows_wrong``), each of which must
    fail it. ``embedding_bag_bwd`` against ``zeros`` +
    ``index_add_``: rows repeated within and across bags (16 rows for 4,800
    entries), empty bags and batches, NNZ 0, D off the float4 width, sum
    and mean; integer-valued inputs exactly (mean with counts of 1, 2, 4
    and 8), normal ones within the atomics' summation bound, each with a
    planted fault (every bag's last entry left out) that must fail it.
    Returns the number of cases and the largest readings by kernel and
    dtype; raises after every case has run if any failed."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_backward
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    gen = torch.Generator(device=dev).manual_seed(17)
    worst, bad = {}, []
    cases = 0

    def note(key, ratio, control):
        w = worst.setdefault(key, {"max_ratio": 0.0,
                                   "min_planted_ratio": float("inf")})
        w["max_ratio"] = max(w["max_ratio"], ratio)
        if control is not None:
            w["min_planted_ratio"] = min(w["min_planted_ratio"], control)

    flash_cases = []   # B, H, Hkv, S, d, window, softcap
    n = 0
    for d in (64, 128, 256):
        for G in (1, 2, 4):
            for win, cap in ((0, 0.0), (48, 0.0), (0, 30.0), (100, 20.0)):
                flash_cases.append((1 + n % 2, 2 * G, 2, 67 + 29 * n, d, win,
                                    cap))
                n += 1
    flash_cases += [(1, 4, 2, 130, 16, 0, 0.0), (1, 8, 2, 97, 32, 1, 0.0),
                    (1, 2, 2, 1, 128, 0, 0.0), (2, 4, 4, 64, 128, 0, 0.0),
                    (1, 16, 8, 1024, 128, 0, 0.0),     # qwen3 heads
                    (1, 8, 4, 600, 256, 256, 50.0)]    # gemma2, local layer
    for name in dtypes:
        dtype = getattr(torch, name)
        for i, (B, H, Hkv, S, d, win, cap) in enumerate(flash_cases):
            cases += 1
            label = f"flash_attention_bwd {name} {flash_cases[i]}"
            q, k, v = _attn_inputs(gen, B, H, Hkv, S, d, dtype, dev,
                                   "bshd" if i % 2 == 0 else "bhsd")
            if cap > 0:     # scores ~ N(0, (c/2)^2): the cap bites, so its
                q = q * (cap / 2)     # factor's planted fault shows
            dout = torch.randn((B, S, H, d), generator=gen, device=dev,
                               dtype=dtype).transpose(1, 2)
            lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            o = flash_attention(q, k, v, window=win, softcap=cap, lse=lse)
            o_ratio = attn_err(o, ref.mha_reference(q, k, v, True, win, cap),
                               split_bound(q, k, v, win, cap))[1]
            note(f"o {name}", o_ratio, None)
            if not o_ratio <= 1.0:
                bad.append(f"{label}: the forward's output {o_ratio}x its "
                           f"tolerance")
            lse_want = ref.mha_lse_reference(q, k, win, cap)
            lse_ratio = float(((lse - lse_want).abs()
                               / (LSE_TOL * lse_want.abs().clamp(min=1.0)))
                              .max())
            note(f"lse {name}", lse_ratio, None)
            if not lse_ratio <= 1.0:
                bad.append(f"{label}: the forward's lse {lse_ratio}x its "
                           f"tolerance")
            got = flash_attention_bwd(q, k, v, o, dout, lse, win, cap)
            want = ref.flash_attention_backward_reference(q, k, v, dout, win,
                                                          cap)
            bound = flash_bwd_bound(q, k, v, o, dout, want, win, cap)
            err, ratio = bwd_err(got, want, bound)
            controls = [bwd_err(flash_bwd_math(
                q, k, v, o, dout, lse, win, cap,
                "softcap" if cap > 0 else "delta"), want, bound)[1]]
            if S >= 64 and win != 1:
                controls.append(bwd_err(late_rows_wrong(got), want,
                                        bound)[1])
            note(f"flash_attention_bwd {name}", ratio, min(controls))
            if not ratio <= 1.0:
                bad.append(f"{label}: max |kernel - plain| {err}, {ratio}x "
                           f"the bound")
            if not min(controls) > 1.0:
                bad.append(f"{label}: a planted fault is within the bound "
                           f"({controls})")

    bag_cases = [  # B, F, NNZ, V, D
        (0, 3, 4, 10, 8), (1, 1, 1, 1, 1), (7, 3, 5, 100, 7),
        (64, 40, 4, 10_000, 32), (5, 2, 37, 50, 33), (3, 2, 3, 20, 300),
        (2, 3, 0, 10, 8), (300, 4, 4, 16, 16), (33, 5, 8, 1000, 64)]
    weights = torch.tensor([0.0, 0.5, 1.0, 2.0], device=dev)
    dyadic = torch.tensor([0, 1, 2, 4, 8], device=dev)
    for name in dtypes:
        dtype = getattr(torch, name)
        for B, F, NNZ, V, D in bag_cases:
            ids = torch.randint(0, V, (B, F, NNZ), generator=gen, device=dev,
                                dtype=torch.int32)
            mask = weights[torch.randint(0, 4, (B, F, NNZ), generator=gen,
                                         device=dev)]
            if B:
                mask[0, 0] = 0.0                        # an empty bag
            # counts of 0, 1, 2, 4 or 8 live entries: mean's divide exact
            allowed = dyadic[dyadic <= NNZ]
            live = allowed[torch.randint(0, allowed.numel(), (B, F, 1),
                                         generator=gen, device=dev)]
            mask01 = (torch.arange(NNZ, device=dev) < live).float()
            g = torch.randn((B, F, D), generator=gen, device=dev).to(dtype)
            ig = torch.randint(-8, 9, (B, F, D), generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)
            planted = bool(B and NNZ)
            for combiner in ("mean", "sum"):
                label = (f"embedding_bag_bwd {name} {combiner} B={B} F={F} "
                         f"NNZ={NNZ} V={V} D={D}")
                cases += 1
                want = ref.embedding_bag_backward_reference(g, ids, mask, V,
                                                            combiner)
                bound = _bag_bwd_bound(g, ids, mask, V, combiner)
                err, ratio = sum_err(
                    embedding_bag_backward(g, ids, mask, V, combiner), want,
                    bound)
                control = (sum_err(ref.embedding_bag_backward_reference(
                    g, ids, planted_bag(mask), V, combiner), want, bound)[1]
                    if planted and bool((mask[..., -1] != 0).any())
                    else None)
                note(f"embedding_bag_bwd {name}", ratio, control)
                if not ratio <= 1.0:
                    bad.append(f"{label}: max |kernel - plain| {err}, "
                               f"{ratio}x the tolerance")
                if control is not None and not control > 1.0:
                    bad.append(f"{label}: a planted fault passes")
                # integer-valued: g in [-8, 8], weights 0, 1/2, 1, 2 (sum)
                # or counts of 1, 2, 4, 8 (mean): every addend and partial
                # sum exact in float32, so any order gives the same bits
                m = mask if combiner == "sum" else mask01
                cases += 1
                iwant = ref.embedding_bag_backward_reference(ig, ids, m, V,
                                                             combiner)
                if not torch.equal(embedding_bag_backward(ig, ids, m, V,
                                                          combiner), iwant):
                    bad.append(f"{label} integer: sums differ")
                if planted and bool((m[..., -1] != 0).any()) and torch.equal(
                        ref.embedding_bag_backward_reference(
                            ig, ids, planted_bag(m), V, combiner), iwant):
                    bad.append(f"{label} integer: planted fault passes")
    _sync(dev)
    if bad:
        raise AssertionError("; ".join(bad))
    return {"cases": cases, **worst}


def lm_loss_check(cfg, seed: int, device, ref_device="cpu") -> dict:
    """One f32 ``lm_loss`` step of ``cfg`` (weights from ``seed``, B = 1,
    GRAD_CHECK_SEQ tokens) on ``device`` through the kernels (the float32
    forward writing lse, ``flash_attention_bwd``) against the same weights
    and tokens on ``ref_device`` (the plain versions): the loss within
    GRAD_TOL * max(1, |loss|) and every gradient leaf within GRAD_TOL *
    max |leaf| of the CPU's. On a card the control runs the card side
    again with TF32 matmuls; ok also needs it outside the tolerance."""
    import torch
    from repro_torch import tree
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.runtime.train_loop import value_and_grad
    dev = torch.device(device)
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), torch.float32, dev)
    tokens = _tokens(seed, (1, GRAD_CHECK_SEQ), cfg.vocab, "cpu")

    def grads(p, d):
        loss, aux, g = value_and_grad(lambda pp, b: lm_loss(cfg, pp, b), p,
                                      tokens.to(d))
        return loss.cpu(), [x.cpu() for x in tree.leaves(g)]

    got_loss, got = grads(params, dev)
    ref_dev = torch.device(ref_device)
    ref_params = _params_to(params, ref_dev)
    want_loss, want = grads(ref_params, ref_dev)
    loss_diff = abs(float(got_loss) - float(want_loss))
    err, ratio = grad_err(got, want, GRAD_TOL)
    control = None
    if dev.type == "cuda":
        matmul = torch.backends.cuda.matmul
        tf32, matmul.allow_tf32 = matmul.allow_tf32, True
        try:
            control = grad_err(grads(params, dev)[1], want, GRAD_TOL)[1]
        finally:
            matmul.allow_tf32 = tf32
    out = {"layers": cfg.n_layers, "seq": GRAD_CHECK_SEQ,
           "loss": float(want_loss), "loss_diff": loss_diff,
           "grad_max_abs_err": err, "grad_ratio": ratio,
           "tf32_control_ratio": control, "leaves": len(want)}
    out["ok"] = (bool(torch.isfinite(got_loss)) and all(
        bool(torch.isfinite(g).all()) for g in got)
        and loss_diff <= GRAD_TOL * max(1.0, abs(float(want_loss)))
        and ratio <= 1.0 and (control is None or control > 1.0))
    return out


def checkpoint_check(state: dict, device) -> dict:
    """``state`` saved twice (steps 1 and 2, the second with every float
    leaf plus one) under ``build/`` and restored on the card: the latest
    equal to the second bit for bit; restoring step 1 must differ (the
    planted fault: a stale checkpoint); a wrong-shape ``like`` raises."""
    import shutil

    import torch
    from repro_torch import tree
    from repro_torch.runtime.checkpoint import (latest_step,
                                                restore_checkpoint,
                                                save_checkpoint)
    d = REPO / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    second = tree.tree_map(lambda x: x + 1 if x.is_floating_point() else x,
                           state)
    t0 = time.perf_counter()
    save_checkpoint(str(d), 1, state)
    save_checkpoint(str(d), 2, second)
    t_save = time.perf_counter() - t0
    like = tree.tree_map(torch.zeros_like, state)
    t0 = time.perf_counter()
    step, got = restore_checkpoint(str(d), like, device=device)
    t_restore = time.perf_counter() - t0
    same = all(torch.equal(a, b) and a.device.type == torch.device(
        device).type for a, b in zip(tree.leaves(got), tree.leaves(second)))
    stale = restore_checkpoint(str(d), like, step=1, device=device)[1]
    stale_same = all(torch.equal(a, b) for a, b in
                     zip(tree.leaves(stale), tree.leaves(second)))
    flat = tree.flatten(like)
    bad_like = tree.unflatten(like, [torch.zeros(x.numel() + 1) if i == 0
                                     else x for i, (_, x) in
                                     enumerate(flat)])
    try:
        restore_checkpoint(str(d), bad_like)
        shape_raises = False
    except ValueError:
        shape_raises = True
    size = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
    latest = latest_step(str(d))
    shutil.rmtree(d, ignore_errors=True)
    out = {"leaves": len(flat), "bytes_on_disk": size, "save_s": t_save,
           "restore_s": t_restore, "latest": latest, "restored": step,
           "equal": same, "stale_equal": stale_same,
           "shape_mismatch_raises": shape_raises}
    out["ok"] = (same and not stale_same and shape_raises and step == 2
                 and latest == 2)
    return out


def train_steps(step_fn, params, opt_state, batch, steps: int,
                device) -> dict:
    """``steps`` AdamW steps on one repeated batch, each timed to its
    loss's read (the step's one host sync), launch counts read over them.
    Returns the losses, step ms, median, peak GB and launches a step."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    _reset_peak(device)
    losses, ms = [], []
    reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_ms": ms, "median_ms": statistics.median(ms),
            "peak_gb": _peak_gb(device),
            "launches_per_step": {k: v / steps for k, v in launches.items()
                                  if "/" not in k},
            "launches": launches}


TRAIN_TRACK = ("dkdv_kernel", "dq_kernel", "delta_kernel", "flash_tc",
               "flash_kernel", "gemm", "nvjet", "elementwise", "reduce")


def lm_train(cfg, seed: int, device) -> dict:
    """qwen3-0.6b at full width and depth, bf16 weights from ``seed``:
    TRAIN_STEPS AdamW steps of ``lm_loss`` on one batch of TRAIN_BATCH x
    TRAIN_SEQ tokens (each layer rematted, attention through the forward
    kernel with lse and ``flash_attention_bwd``), then one step under the
    profiler. The loss must be finite and fall."""
    import torch
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.train_loop import make_train_step
    dev = torch.device(device)
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), torch.bfloat16, dev)
    tokens = _tokens(seed, (TRAIN_BATCH, TRAIN_SEQ), cfg.vocab, dev)
    step = make_train_step(lambda p, b: lm_loss(cfg, p, b),
                           AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=0))
    run = train_steps(step, params, adamw_init(params), tokens, TRAIN_STEPS,
                      dev)
    prof = device_profile(lambda: step(run["params"], run["opt_state"],
                                       tokens), TRAIN_TRACK) \
        if dev.type == "cuda" else None
    losses = run["losses"]
    out = {k: run[k] for k in ("losses", "step_ms", "median_ms", "peak_gb",
                               "launches_per_step")}
    out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (run["median_ms"] / 1e3)
    out["profile"] = prof
    out["launches"] = run["launches"]
    out["ok"] = (all(math.isfinite(x) for x in losses)
                 and losses[-1] < losses[0])
    return out


def recsys_train(cfg, seed: int, device) -> dict:
    """Wide&Deep at full width (f32 weights from ``seed``): TRAIN_STEPS
    AdamW steps of ``recsys_loss`` on one ``recsys_batch`` of
    RECSYS_TRAIN_BATCH samples (bags through ``embedding_bag`` and its
    backward ``embedding_bag_bwd``: a dense gradient of the 40M-row
    table), then one step under the profiler. The loss must be finite and
    fall."""
    import torch
    from repro_torch.data.recsys import recsys_batch
    from repro_torch.models.recsys import init_recsys_params, recsys_loss
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.train_loop import make_train_step
    dev = torch.device(device)
    params = init_recsys_params(cfg, torch.Generator(
        device=dev).manual_seed(seed), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in recsys_batch(
        RECSYS_TRAIN_BATCH, n_sparse=cfg.n_sparse, vocab=cfg.vocab_per_field,
        nnz=cfg.nnz_per_field, n_dense=cfg.n_dense, seed=seed).items()}
    step = make_train_step(lambda p, b: recsys_loss(cfg, p, b),
                           AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=0))
    run = train_steps(step, params, adamw_init(params), batch, TRAIN_STEPS,
                      dev)
    prof = device_profile(lambda: step(run["params"], run["opt_state"],
                                       batch),
                          ("embedding_bag", "index", "gemm", "nvjet",
                           "elementwise", "Memset")) \
        if dev.type == "cuda" else None
    losses = run["losses"]
    out = {k: run[k] for k in ("losses", "step_ms", "median_ms", "peak_gb",
                               "launches_per_step")}
    out["samples_per_s"] = RECSYS_TRAIN_BATCH / (run["median_ms"] / 1e3)
    out["profile"] = prof
    out["launches"] = run["launches"]
    out["batch"] = batch
    out["ok"] = (all(math.isfinite(x) for x in losses)
                 and losses[-1] < losses[0])
    return out


def _sdpa_backward(q, k, v, dout):
    """The backward of one ``scaled_dot_product_attention`` call (causal,
    fused backends) through autograd: the yardstick of
    ``flash_attention_bwd``, never used by the port. ``None`` where no
    fused backend takes these inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    G = q.shape[1] // k.shape[1]
    for how in ("enable_gqa", "expanded heads"):
        qq = q.detach().contiguous().requires_grad_()
        if how == "enable_gqa":
            kk, vv, kw = k.detach().contiguous(), v.detach().contiguous(), \
                {"enable_gqa": True}
        else:
            kk = k.detach().repeat_interleave(G, 1).contiguous()
            vv = v.detach().repeat_interleave(G, 1).contiguous()
            kw = {}
        kk.requires_grad_()
        vv.requires_grad_()
        try:
            with sdpa_kernel(fused):
                o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                   **kw)
            go = dout.contiguous()
            torch.autograd.grad(o, (qq, kk, vv), go, retain_graph=True)
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as exc:
            log(f"sdpa backward ({how}) refused: {str(exc)[:120]}")
            continue
        return (lambda: torch.autograd.grad(o, (qq, kk, vv), go,
                                            retain_graph=True)), how
    return None, None


def flash_bwd_row(cfg, launches: dict, hbm: float) -> dict:
    """``flash_attention_bwd`` at the training step's shape (one layer of
    ``cfg``: B = TRAIN_BATCH, S = TRAIN_SEQ, bf16, the model's strided
    layout) against autograd of the plain version on the same card inputs,
    element by element within ``flash_bwd_bound``, with two planted faults
    (Delta left out; ``late_rows_wrong``) failing it, after the forward
    that feeds it (the output within ``attn_err``'s split bound, the row
    lse within LSE_TOL) is held against the plain version; timed beside
    its bound (2.5x the forward's operations at the bf16
    tensor-core rate, or its bytes), the plain version and SDPA's
    backward."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = _attn_inputs(gen, B, H, Hkv, S, d, torch.bfloat16, dev)
    dout = torch.randn((B, S, H, d), generator=gen, device=dev,
                       dtype=torch.bfloat16).transpose(1, 2)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    o = flash_attention(q, k, v, lse=lse)
    shape = f"B={B} H={H} Hkv={Hkv} S={S} d={d} bf16"
    o_err, o_ratio = attn_err(o, ref.mha_reference(q, k, v),
                              split_bound(q, k, v))
    lse_want = ref.mha_lse_reference(q, k)
    lse_ratio = float(((lse - lse_want).abs()
                       / (LSE_TOL * lse_want.abs().clamp(min=1.0))).max())
    del lse_want
    if not (o_ratio <= 1.0 and lse_ratio <= 1.0):
        raise AssertionError(f"flash_attention [{shape}] with lse: output "
                             f"{o_ratio}x, lse {lse_ratio}x the tolerance")

    def kern():
        return flash_attention_bwd(q, k, v, o, dout, lse)

    def plain():
        return ref.flash_attention_backward_reference(q, k, v, dout)

    want = plain()
    got = kern()
    bound = flash_bwd_bound(q, k, v, o, dout, want)
    err, ratio = bwd_err(got, want, bound)
    controls = {
        "delta": bwd_err(flash_bwd_math(q, k, v, o, dout, lse,
                                        fault="delta"), want, bound)[1],
        "late_rows": bwd_err(late_rows_wrong(got), want, bound)[1]}
    del want, got, bound
    torch.cuda.empty_cache()
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention_bwd [{shape}]: {ratio}x the "
                             f"bound (max abs err {err})")
    if not min(controls.values()) > 1.0:
        raise AssertionError(f"flash_attention_bwd [{shape}]: a planted "
                             f"fault is within the bound ({controls})")
    pairs = B * H * S * (S + 1) // 2
    flops = 2.5 * 4 * d * pairs
    nbytes = 2 * (4 * B * H * S * d + 4 * B * Hkv * S * d) + 4 * B * H * S
    lib, how = _sdpa_backward(q, k, v, dout)
    t_bytes, t_ops = nbytes / hbm * 1e3, flops / BF16_OPS_PER_S * 1e3
    row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": BWD_SOURCE["flash_attention_bwd"],
        "replaces": BWD_REPLACES["flash_attention_bwd"],
        "launches": int(launches.get("flash_attention_bwd", 0)),
        "max_abs_err": err, "ms": time_ms(kern, calls=3, reps=5),
        "plain_ms": time_ms(plain, calls=1, reps=1),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_ms(lib, calls=3, reps=5) if lib else None,
    }
    log(f"kernel flash_attention_bwd [{shape}]: kernel_ms={row['ms']} "
        f"bound_ms={row['bound_ms']} ({row['bound_by']}; {flops} operations,"
        f" 2.5x the forward's) plain_ms={row['plain_ms']} library_ms="
        f"{row['library_ms']} (SDPA backward through autograd, {how}) "
        f"launches={row['launches']} max_abs_err={err} ({ratio}x "
        f"flash_bwd_bound; planted faults {json.dumps(controls)}); forward "
        f"with lse: output {o_ratio}x (max abs err {o_err}), lse "
        f"{lse_ratio}x the tolerance; {flops / row['ms'] / 1e9} TFLOP/s "
        f"achieved by that count")
    del q, k, v, o, dout, lse, lib
    torch.cuda.empty_cache()
    return row


def bag_bwd_row(cfg, batch: dict, launches: dict, hbm: float) -> dict:
    """``embedding_bag_bwd`` at the Wide&Deep training step's shape (the
    unified 40M-row table, the batch's field-offset ids and mask, a
    random output gradient) against ``zeros`` + ``index_add_``: exactly on
    an integer-valued gradient under ``sum``, within the atomics'
    summation bound on a normal one under both combiners, each against
    the planted fault (every bag's last entry left out). Timed beside its
    bound (its bytes: g, ids and mask read, the dense gradient written
    once), the plain version and ``index_add_`` into zeros."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_backward
    from repro_torch.models.recsys import _field_ids
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    ids = _field_ids(batch["ids"], cfg.vocab_per_field)
    mask = batch["id_mask"]
    B, F_, NNZ = ids.shape
    V, D = cfg.unified_rows, cfg.embed_dim
    shape = f"B={B} F={F_} NNZ={NNZ} V={V} D={D} f32"
    checks = {}
    ig = torch.randint(-8, 9, (B, F_, D), generator=gen, device=dev,
                       dtype=torch.float32)
    want = ref.embedding_bag_backward_reference(ig, ids, mask, V, "sum")
    got = embedding_bag_backward(ig, ids, mask, V, "sum")
    planted = ref.embedding_bag_backward_reference(ig, ids, planted_bag(mask),
                                                   V, "sum")
    checks["exact sum"] = [float((got - want).abs().max()),
                           float((planted - want).abs().max())]
    del ig, want, got, planted
    g = torch.randn((B, F_, D), generator=gen, device=dev)
    for combiner in ("mean", "sum"):
        want = ref.embedding_bag_backward_reference(g, ids, mask, V,
                                                    combiner)
        bound = _bag_bwd_bound(g, ids, mask, V, combiner)
        err = sum_err(embedding_bag_backward(g, ids, mask, V, combiner),
                      want, bound)
        control = sum_err(ref.embedding_bag_backward_reference(
            g, ids, planted_bag(mask), V, combiner), want, bound)
        checks[f"float32 {combiner}"] = [*err, *control]
        del want, bound
        torch.cuda.empty_cache()
    _sync(dev)
    bad = [k for k, v in checks.items()
           if (not (v[0] == 0 and v[1] > 0) if k.startswith("exact")
               else not v[1] <= 1.0 < v[3])]
    if bad:
        raise AssertionError(f"embedding_bag_bwd [{shape}]: {bad}: {checks}")
    m = mask.float()
    w = m / m.sum(dim=2, keepdim=True).clamp(min=1.0)
    contrib = (g[:, :, None, :] * w[..., None]).reshape(-1, D)
    flat = ids.reshape(-1).long()

    def library():
        return torch.zeros((V, D), device=dev).index_add_(0, flat, contrib)

    n = ids.numel()
    nbytes = B * F_ * D * 4 + 8 * n + V * D * 4
    row = {
        "name": "embedding_bag_bwd", "route": "cuda",
        "source": BWD_SOURCE["embedding_bag_bwd"],
        "replaces": BWD_REPLACES["embedding_bag_bwd"],
        "launches": int(launches.get("embedding_bag_bwd", 0)),
        "max_abs_err": checks["float32 mean"][0],
        "ms": time_ms(lambda: embedding_bag_backward(g, ids, mask, V)),
        "plain_ms": time_ms(lambda: ref.embedding_bag_backward_reference(
            g, ids, mask, V), calls=1, reps=3),
        "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(library),
    }
    log(f"kernel embedding_bag_bwd [{shape}]: kernel_ms={row['ms']} "
        f"bound_ms={row['bound_ms']} (bytes: g, ids, mask read, the "
        f"{V * D * 4} bytes of the dense gradient written once) "
        f"plain_ms={row['plain_ms']} library_ms={row['library_ms']} "
        f"(index_add_ into zeros of the weighted rows) launches="
        f"{row['launches']} checks [max_abs_err, ratio, planted max_abs_err,"
        f" planted ratio]: {json.dumps(checks)}")
    del g, contrib, flat
    torch.cuda.empty_cache()
    return row


def train_phase(args, hbm: float, device) -> tuple[list[dict], dict]:
    """Training on the card: both backward kernels' edge cases, the f32
    ``lm_loss`` step card vs CPU at GRAD_CHECK_LAYERS layers of full width
    with its TF32 control, a checkpoint of that state saved and restored on
    the card, qwen3-0.6b (full width and depth, bf16) and Wide&Deep (full
    width, f32) taking TRAIN_STEPS AdamW steps each, then the backward
    kernels' rows. Launch counts are reset before each model's steps and
    read after them. Returns the two rows and the launches of every kernel
    over both models' steps."""
    import dataclasses as dc

    import torch
    from repro_torch.configs.registry import get_spec
    from repro_torch.optim.adamw import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 checks
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    t0 = time.perf_counter()
    cases = check_backward_cases(device)
    log(f"train: backward edge cases (flash within flash_bwd_bound: rel "
        f"{BWD_REL}, sum {BWD_SUM}, delta {BWD_DELTA}; lse within "
        f"{LSE_TOL}; bags within the summation bound, "
        f"integer-valued exactly): {json.dumps(cases)} in "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = get_spec(LM_ARCH).config
    small = dc.replace(cfg, n_layers=GRAD_CHECK_LAYERS)
    t0 = time.perf_counter()
    check = lm_loss_check(small, args.seed, device)
    log(f"train: lm_loss f32 step card vs CPU ({small.name} at "
        f"{GRAD_CHECK_LAYERS} layers, full width): {json.dumps(check)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if not check["ok"]:
        raise AssertionError(f"lm_loss card vs CPU: {check}")
    from repro_torch.models.transformer import init_lm_params
    params = init_lm_params(small, torch.Generator(device=device).manual_seed(
        args.seed), torch.float32, device)
    ck = checkpoint_check({"params": params, "opt": adamw_init(params)},
                          device)
    log(f"train: checkpoint on the card: {json.dumps(ck)}")
    if not ck["ok"]:
        raise AssertionError(f"checkpoint round trip: {ck}")
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm = lm_train(cfg, args.seed, device)
    prof = lm.pop("profile")
    launches = lm.pop("launches")
    log(f"train lm ({cfg.name}, {cfg.n_layers} layers, bf16 params, f32 "
        f"moments, B={TRAIN_BATCH} S={TRAIN_SEQ}) on {gpu}: "
        f"{json.dumps(lm)} in {time.perf_counter() - t0:.1f} s")
    log(f"train lm profile (one step): {json.dumps(prof)}")
    want = {"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"train lm launches {got}, want {want} (each "
                             f"layer's forward, its recompute and its "
                             f"backward)")
    if not lm["ok"]:
        raise AssertionError(f"train lm: the loss did not fall or is not "
                             f"finite: {lm['losses']}")
    torch.cuda.empty_cache()
    rows = [flash_bwd_row(cfg, launches, hbm)]

    rcfg = get_spec(RECSYS_ARCH).config
    t0 = time.perf_counter()
    rs = recsys_train(rcfg, args.seed, device)
    rprof = rs.pop("profile")
    rlaunches = rs.pop("launches")
    batch = rs.pop("batch")
    log(f"train recsys ({rcfg.name}, {rcfg.unified_rows} x "
        f"{rcfg.embed_dim} table, f32, B={RECSYS_TRAIN_BATCH}) on {gpu}: "
        f"{json.dumps(rs)} in {time.perf_counter() - t0:.1f} s")
    log(f"train recsys profile (one step): {json.dumps(rprof)}")
    want = {"embedding_bag": TRAIN_STEPS, "embedding_bag_bwd": TRAIN_STEPS}
    got = {k: rlaunches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"train recsys launches {got}, want {want}")
    if not rs["ok"]:
        raise AssertionError(f"train recsys: the loss did not fall or is "
                             f"not finite: {rs['losses']}")
    torch.cuda.empty_cache()
    rows.append(bag_bwd_row(rcfg, batch, rlaunches, hbm))
    del batch
    torch.cuda.empty_cache()
    return rows, {**{k: v for k, v in launches.items() if "/" not in k},
                  **{k: v for k, v in rlaunches.items() if "/" not in k}}


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
    shown = {k: v for k, v in res.items()
             if k not in ("backend", "probe_largest")}
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
                    help="the LM and MoE phases alone (a short run "
                         "after an attention kernel edit)")
    ap.add_argument("--sparse-only", action="store_true",
                    help="the recsys and GNN phases alone (a short run "
                         "after a sparse kernel edit)")
    ap.add_argument("--train-only", action="store_true",
                    help="the training phase alone (a short run after a "
                         "backward kernel edit)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LM, MoE, recsys and GNN phases' "
                         "weights and inputs")
    ap.add_argument("--prefill-seq", type=int, default=32768)
    ap.add_argument("--decode-cache", type=int, default=32768)
    ap.add_argument("--decode-steps", type=int, default=64)
    args = ap.parse_args(argv)
    if sum((args.lm_only, args.sparse_only, args.train_only)) > 1:
        ap.error("--lm-only, --sparse-only and --train-only exclude each "
                 "other")
    only = args.lm_only or args.sparse_only or args.train_only

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
    if not only:
        t0 = time.perf_counter()
        n_edge = check_edge_cases(dev)
        log(f"edge cases: {n_edge} exact in {time.perf_counter() - t0:.1f} s")

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
        del full
        torch.cuda.empty_cache()

    if not (args.sparse_only or args.train_only):
        t0 = time.perf_counter()
        rows += lm_phase(args, hbm, dev)
        log(f"lm phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        moe = moe_phase(args, hbm, dev)
        for row in rows:
            if row["name"] in LM_REPLACES:
                row["moe_launches"] = {arch: got[row["name"]]
                                       for arch, got in moe.items()}
        log(f"moe phase {time.perf_counter() - t0:.1f} s")

    if not (args.lm_only or args.train_only):
        t0 = time.perf_counter()
        cases = check_sparse_cases(dev)
        log(f"sparse edge cases within SUM_GROWTH {SUM_GROWTH} and rtol "
            f"{SUM_RTOL} (integer-valued ones exact): {json.dumps(cases)} "
            f"in {time.perf_counter() - t0:.1f} s")
        rows += recsys_phase(args, hbm, dev)
        log(f"recsys phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rows += gnn_phase(args, hbm, dev)
        log(f"gnn phase {time.perf_counter() - t0:.1f} s")

    if not (args.lm_only or args.sparse_only):
        t0 = time.perf_counter()
        train_rows, train_launches = train_phase(args, hbm, dev)
        for row in rows:     # the forward kernels' launches in those steps
            if row["name"] in ("flash_attention", "embedding_bag"):
                row["train_launches"] = int(train_launches.get(row["name"],
                                                               0))
        rows += train_rows
        log(f"train phase {time.perf_counter() - t0:.1f} s")

    if not only:
        # the paper's system on the SPARQL phases' stores, last: its long
        # host-bound rounds perturb no earlier phase's measurements
        t0 = time.perf_counter()
        kept_a, kept_b = {}, {}
        sys_a = system_phase(gen, gen.store, dev, args.max_rows, keep=kept_a)
        log_system(sys_a, gpu)
        # launches of one cold bnb round (the ten rounds' total is logged)
        cold_bnb = sys_a["rounds"]["bnb"]["cold"]["launches"]
        for row in rows:
            if row["name"] in REPLACES:
                row["system_launches"] = int(cold_bnb.get(row["name"], 0))
        sys_b = ingest_phase(small, sharded, dev, args.sharded_max_rows,
                             keep=kept_b)
        log(f"system ingest (scale {args.sharded_scale}, 4 shards) on "
            f"{gpu}: {json.dumps(sys_b)}")
        log(f"system phase {time.perf_counter() - t0:.1f} s")
        # the serving front end on the same two systems, no second placement
        t0 = time.perf_counter()
        serve, qad_row = serve_phase(gen, small, kept_a, kept_b, dev,
                                     args.max_rows, hbm)
        log_serve(serve, gpu)
        rows.append(qad_row)
        log(f"serve phase {time.perf_counter() - t0:.1f} s")
        del gen, small, sharded, sys_a, sys_b, kept_a, kept_b, serve
        torch.cuda.empty_cache()

    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
