#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SPARQL serving path on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the CUDA kernels of ``src/repro_torch/csrc`` with ``nvcc``.
2. Serving, full size: a WatDiv-like graph of about 10M triples
   (``generate_watdiv_like(scale=1000)``) behind ``repro_torch.SparqlEndpoint``
   on ``cuda``; one cold and one warm ``query_many`` over a query mix, every
   answer held against the port's ``NumpyBackend`` as multisets, the host
   transfer contract (2 cold, 0 warm), every kernel launched at least once,
   and ``MatchCapacityError`` on both backends for a star2 query.
3. The same on a 4-shard store at scale 100.
4. Each kernel held against its plain torch version on the card at the
   serving shapes and on edge cases (exact equality: all results are
   integers), and timed beside its bound.

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
    profile = (device_profile(ep, texts) if backend.device.type == "cuda"
               else None)

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


def device_profile(ep, texts: list[str]) -> dict:
    """Device time of one steady cold batch under ``torch.profiler``: the
    sum over kernels and copies, its share of the batch's wall time (which
    the profiler itself inflates), and the largest items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ep.clear_cache()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ep.query_many(texts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    items = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                    for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA")), reverse=True)
    device_ms = sum(ms for ms, _, _ in items)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [[key[:60], ms, n] for ms, key, n in items[:8]]}


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
    lib = _build.build()
    _build.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    if _build.build_log():
        log(_build.build_log().strip())
    gpu = gpu_line()
    hbm = hbm_rate(gpu)
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {gpu}")

    n_edge = check_edge_cases(dev)
    log(f"edge cases: {n_edge} exact")

    t0 = time.perf_counter()
    gen = generate_watdiv_like(scale=args.scale, seed=0)
    log(f"data: scale {args.scale}, {gen.store.num_triples} triples, "
        f"{gen.dictionary.num_entities} entities in "
        f"{time.perf_counter() - t0:.1f} s")
    full = run_phase("full", gen, gen.store, args.queries, args.max_rows,
                     dev)

    rows = kernel_phase(gen.store, gen.dictionary, full["backend"], full,
                        hbm)

    t0 = time.perf_counter()
    small = generate_watdiv_like(scale=args.sharded_scale, seed=0)
    sharded = ShardedTripleStore.from_store(small.store, 4)
    log(f"data: scale {args.sharded_scale}, 4 shards "
        f"{[sh.num_triples for sh in sharded.shards]} in "
        f"{time.perf_counter() - t0:.1f} s")
    run_phase("sharded", small, sharded, args.queries, args.sharded_max_rows,
              dev)

    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
