#!/usr/bin/env python3
"""Time ``embedding_bag`` and ``scan_probe`` beside timing-only variants of
themselves, on one NVIDIA GPU.

    python3 chip_variants.py            # from the root of a checkout

A variant is either a plan that the launchers would not pick (ids and mask
read from device memory instead of through the ring, one element a lane
instead of 16 bytes, another grid, another sample size) or a copy of a
kernel's source with one part changed by a text substitution (its L2
hints, the out-of-range shortcut), compiled at run time under
``build/variants``. No variant is part of the port. Each variant's output
is checked bit for bit against the shipped kernel's before it is timed;
the variants then run in turns, forward and backward (CUDA events over
back-to-back calls, ``chip_smoke.time_ms``).

``embedding_bag`` runs at wide-deep's ``serve_bulk`` shape (262,144
samples x 40 fields of 4 ids, D = 32 float32, u^3 ids). ``scan_probe``
runs at the SPARQL phase's shape (``generate_watdiv_like(scale=1000)``:
9,963,797 triples, the 1,347,882 sorted ``follows`` subjects as keys,
every object as a probe) and on two controls of the same size: probes
drawn uniformly from the keys' range, and probes above every key. The
last line is one JSON object of every time in ms, beside the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CSRC = REPO / "src" / "repro_torch" / "csrc"
OUT = REPO / "build" / "variants"
# the shipped row loads and output stores of the float32 routes (16 bytes
# and one element a lane), and the bulk copies' cache hint
_LOADS = ['asm("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\\n"',
          'asm("ld.global.nc.f32 %0, [%1];\\n"']
_STORES = ['asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\\n"',
           'asm volatile("st.global.cs.f32 [%0], %1;\\n"']
_COPY = '".L2::cache_hint [%0], [%1], %2, [%3], %4;\\n"'


def _evict_last(load: str) -> str:
    """``load`` with an evict_last L2 policy made inside the asm."""
    op, rest = load[len('asm("'):].split(" ", 1)
    return ('asm("{\\n.reg .b64 q;\\ncreatepolicy.fractional.L2::evict_last'
            '.b64 q, 1.0;\\n' + op.replace("ld.global.nc.",
                                             "ld.global.nc.L2::cache_hint.")
            + " " + rest.replace("];\\n", "], q;\\n}\\n"))


# name: (source file, [(shipped text, variant text)])
VARIANTS = {
    # no L2 hints at all: plain stores, bulk copies without a policy
    "bag_nohint": ("sparse_kernels.cu", [
        *[(st, st.replace("st.global.cs.", "st.global.")) for st in _STORES],
        (_COPY, '" [%0], [%1], %2, [%3];\\n"')]),
    # the shipped hints plus an evict_last policy on every row load
    "bag_evictlast": ("sparse_kernels.cu", [
        (ld, _evict_last(ld)) for ld in _LOADS]),
    # every row searched, in range or not
    "probe_noshortcut": ("rdf_kernels.cu", [
        ("in[r] = K > 0 && r0 + r < T && v[r] >= first && v[r] <= last;",
         "in[r] = K > 0 && r0 + r < T;")]),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def variant_sources() -> dict[str, str]:
    """Each variant's source text; raises if a substitution does not find
    its text in the shipped source exactly once."""
    out = {}
    for name, (src, subs) in VARIANTS.items():
        text = (CSRC / src).read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {src} once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(nvcc_flags: list[str], nvcc: str) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *nvcc_flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    import chip_smoke as smoke
    from repro_torch.configs.registry import get_spec
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.embedding_bag import (BAG_THREADS, bag_plan,
                                                   embedding_bag)
    from repro_torch.kernels.join_probe import probe_plan, scan_probe
    from repro_torch.models.recsys import _field_ids
    from repro_torch.rdf.generator import generate_watdiv_like
    from repro_torch.sparql.engine import TorchBackend

    t0 = time.perf_counter()
    _build.build("sparse", "rdf")
    libs = build_variants(_build.NVCC_FLAGS, _build._nvcc())
    libs["bag"] = _build.library("sparse")
    libs["probe"] = _build.library("rdf")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in VARIANTS:
        if name.startswith("bag"):
            libs[name].sparse_embedding_bag.argtypes = \
                [P, P, P, P, I, L, I, I, I, I, I, I, I, I, P]
        else:
            libs[name].rdf_scan_probe.argtypes = \
                [P, L, I, I, I, P, I, I, I, I, I, I, P, P, P, P, P]
    gpu = smoke.gpu_line()
    log(f"build {time.perf_counter() - t0:.1f} s; {gpu}")
    dev = torch.device("cuda")
    times: dict[str, float] = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_in_turns(label, order, want, calls):
        for name, fn in order:
            got = fn()
            same = all(torch.equal(g, w) for g, w in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,)))
            if not same:
                raise AssertionError(f"{label} {name}: output differs")
        for rnd, seq in enumerate((order, order[::-1])):
            for name, fn in seq:
                ms = smoke.time_ms(fn, calls=calls)
                times[f"{label} {name} [{rnd}]"] = ms
                log(f"{label} {name} [{rnd}]: {ms} ms")

    # ------------------------------------------------------ embedding_bag
    cfg = get_spec(smoke.RECSYS_ARCH).config
    data = smoke._recsys_inputs(cfg, 262_144, 2, dev)
    ids = _field_ids(data["ids"], cfg.vocab_per_field)
    mask = data["id_mask"]
    B, F, NNZ = ids.shape
    D = cfg.embed_dim
    table = torch.randn((cfg.n_sparse * cfg.vocab_per_field, D),
                        generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    n_bags = B * F

    def bag(lib, vec, ring, blocks=None):
        plan = bag_plan(n_bags, NNZ, D, 4, aligned=vec > 1)
        lanes = plan.lanes
        chunk = plan.chunk if ring else BAG_THREADS // lanes
        out = torch.empty((B, F, D), device=dev)
        rc = libs[lib].sparse_embedding_bag(
            table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
            out.data_ptr(), 0, n_bags, NNZ, D, 1, vec, lanes, chunk,
            blocks or plan.blocks, int(ring), stream())
        if rc:
            raise RuntimeError(f"embedding_bag variant: CUDA error {rc}")
        return out

    want = embedding_bag(table, ids, mask)
    order = [
        ("shipped", lambda: embedding_bag(table, ids, mask)),
        ("none of the three", lambda: bag("bag_nohint", 1, False)),
        ("(a) ring alone", lambda: bag("bag_nohint", 1, True)),
        ("(b) 16-byte rows alone", lambda: bag("bag_nohint", 4, False)),
        ("(c) hints alone", lambda: bag("bag_evictlast", 1, False)),
        ("(c) shipped hints alone", lambda: bag("bag", 1, False)),
        ("(a)+(b)", lambda: bag("bag_nohint", 4, True)),
        ("shipped + evict_last row loads",
         lambda: bag("bag_evictlast", 4, True)),
        ("shipped, 8 blocks an SM", lambda: bag("bag", 4, True, 132 * 8)),
    ]
    run_in_turns("embedding_bag", order, want, calls=5)
    del table, data, ids, mask, want
    torch.cuda.empty_cache()

    # --------------------------------------------------------- scan_probe
    t0 = time.perf_counter()
    gen = generate_watdiv_like(scale=1000, seed=0)
    backend = TorchBackend(device=dev)
    follows = gen.dictionary.predicate_id("follows")
    real = (backend._triples(gen.store),
            backend._pred_views(gen.store, follows)[0][0])
    T, K = real[0].shape[0], real[1].shape[0]
    log(f"WatDiv-like scale 1000: T={T} K={K} in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lo_k, hi_k = int(real[1][0]), int(real[1][-1])
    tri = real[0].clone()
    tri[:, 2] = torch.from_numpy(rng.integers(lo_k, hi_k + 1, T).astype(
        np.int32)).to(dev)
    above = real[0].clone()
    above[:, 2] = hi_k + 1 + above[:, 2].abs() % 1000
    pat = (-1, follows, -1)

    def probe(lib, rows, keys, stride=None, vec=1):
        plan = probe_plan(T, K, True)
        stride = stride or plan.stride
        n_samples = -(-K // stride)
        sample = torch.empty(n_samples, dtype=torch.int32, device=dev)
        out = [torch.empty(T, dtype=torch.int32, device=dev)
               for _ in range(3)]
        rc = libs[lib].rdf_scan_probe(
            rows.data_ptr(), T, *pat, keys.data_ptr(), K, 2, stride,
            n_samples, vec, plan.blocks, sample.data_ptr(),
            *(o.data_ptr() for o in out), stream())
        if rc:
            raise RuntimeError(f"scan_probe variant: CUDA error {rc}")
        return tuple(out)

    for label, rows in (("real", real[0]), ("uniform in range", tri),
                        ("all above the keys", above)):
        keys = real[1]
        want = ref.scan_probe_reference(rows, *pat, keys, 2)
        if smoke.max_abs_err(scan_probe(rows, pat, keys, 2), want):
            raise AssertionError(f"scan_probe {label}: differs from plain")
        order = [
            ("shipped", lambda: scan_probe(rows, pat, keys, 2)),
            ("no out-of-range shortcut",
             lambda: probe("probe_noshortcut", rows, keys)),
            ("sample 8192", lambda: probe("probe", rows, keys,
                                          -(-K // 8192))),
            ("sample 16384", lambda: probe("probe", rows, keys,
                                           -(-K // 16384))),
            ("scalar row loads", lambda: probe("probe", rows, keys, vec=0)),
        ]
        run_in_turns(f"scan_probe {label}", order, want, calls=20)
        del want
    print(gpu)
    print(json.dumps({"gpu": gpu, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
