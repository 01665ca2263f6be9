#!/usr/bin/env python3
"""Time ``embedding_bag``, ``scan_probe``, ``segment_sum_sorted``,
``probe_sorted_many``, ``qad_solve``, ``flash_attention_bwd``,
``decode_attention`` and the float32 attention routes beside timing-only
variants of themselves, on one NVIDIA GPU.

    python3 chip_variants.py            # from the root of a checkout:
                                        # every section but decode
    python3 chip_variants.py --kernels segment,probe
                                        # some of the eight sections
    git archive <commit> src/repro_torch/csrc/flash_tc.cu \
        src/repro_torch/csrc/flash_bwd_tc.cu | tar -x -C build/parent
    python3 chip_variants.py --kernels f32 \
        --parent-bf16 build/parent/src/repro_torch/csrc
                                        # the float32 routes, and the bf16
                                        # ones beside an earlier build
    git archive <commit> src/repro_torch/csrc/flash_f32_tc.cu \
        src/repro_torch/csrc/flash_bwd_f32_tc.cu | tar -x -C build/parent
    python3 chip_variants.py --kernels f32 \
        --parent-f32 build/parent/src/repro_torch/csrc
                                        # and the float32 routes at d = 64,
                                        # 128 and 256 beside an earlier build
    git show <commit>:src/repro_torch/csrc/decode_tc.cu \
        > build/parent/decode_tc.cu
    python3 chip_variants.py --kernels decode
                                        # the shipped decode kernel beside
                                        # an earlier build of its source

A variant is either a plan that the launchers would not pick (ids and mask
read from device memory instead of through the ring, one element a lane
instead of 16 bytes, another grid, another sample size, another number of
ring stages, the scalar route on aligned data) or a copy of a kernel's
source with one part changed by a text substitution (its L2 hints, the
out-of-range shortcut, no run carried across chunks, the replaced probe
kernel appended), compiled at run time under ``build/variants``. No
variant is part of the port. Each variant's output is checked bit for bit
against the shipped kernel's before it is timed (the segment sums on
integer-valued messages, exact in any order); the variants then run in
turns, forward and backward (CUDA events over back-to-back calls,
``chip_smoke.time_ms``).

``embedding_bag`` runs at wide-deep's ``serve_bulk`` shape (262,144
samples x 40 fields of 4 ids, D = 32 float32, u^3 ids). ``scan_probe``
runs at the SPARQL phase's shape (``generate_watdiv_like(scale=1000)``:
9,963,797 triples, the 1,347,882 sorted ``follows`` subjects as keys,
every object as a probe) and on two controls of the same size: probes
drawn uniformly from the keys' range, and probes above every key. The
last line is one JSON object of every time in ms, beside the card's name
and power limit.

``segment_sum_sorted`` runs at the GCN forward's three launches on
ogb_products' size (61,841,859 edges drawn by ``chip_smoke.gnn_graph``, D
= 16, 7 and 1). ``probe_sorted_many`` runs at K = P = 1,347,882 (the
sorted ``follows`` subjects as keys, their objects as probes) and at
4,000 of those probes, where the plan shrinks the sample, and in the
steady cold batch of ``chip_smoke.py``'s query mix, where the replaced
kernel stands in behind the same wrapper: the profiler's device time of
the batch's launches of each (the gathers there include ``scan_probe``'s).

``qad_solve`` runs at the round's shape (a seeded instance of B = 4
children, N = 21 rows, K = 4 edges, 200 iterations) and at the register
route's seeded shapes of ``chip_smoke.QAD_SEEDED``: the shipped register
route, the generic route forced on the same instance (the kernel the
register route replaced on these shapes), the register route without the
bisection's early exit (held to the shipped output bit for bit, which
checks on the card that the early exit is exact), the bisection with a
vote before every step instead of every second one (held to it bit for
bit too) and the register route with an exact projection in place of the
bisection (each row's threshold found from the 2K breakpoints of its
clipped sum; timing only, its D error against the plain version logged). Each is also timed by the profiler's
device time a launch. Then B&B on a seeded instance of the round's shape
(21 users, 4 edges) on R-QAD with each route behind the wrapper, and on
the marginal bound, in turns (same objective and assignment), and the
device's busy share of one B&B on the shipped route.

``flash_attention_bwd`` (``--kernels bwd``) runs at qwen3-0.6b's training
shape (B 8, S 2,048, H 16/8, d 128, bf16, the model's strided layout) and
at gemma2-2b's (one ``train_4k`` microbatch's layer: B 1, S 4,096, H 8/4,
d 256, softcap 50): the shipped tensor-core route
(``csrc/flash_bwd_tc.cu``) beside the SIMT kernel the bf16 route took
before (``csrc/flash_bwd.cu``, called on its library directly by
``chip_smoke.simt_bwd``), both held to ``chip_smoke.flash_bwd_bound``
first, the tensor-core route's output to a first call's bit for bit; then
the profiler's device time of each of its three kernels, and last the
library's ``-Xptxas=-v`` lines (registers, spills and shared memory of
each instance, the D = 256 ones among them). At d = 256 the shipped plan
also runs beside two builds of the same source: ``bwd_whole``, with
``EXCHANGE`` false (each warpgroup takes the whole score tile, where the
shipped two exchange their partial tiles), and ``bwd_head_major``, with
``TILE_MAJOR`` false (d <= 128's block order); each held to the bound and
timed in turns with its device times, and their ``-Xptxas=-v`` lines. Last,
the device times of ``dkdv_tc_kernel`` and ``dq_tc_kernel`` in five
timing-only builds, each with one phase taken out (``BWD_PHASES``: the P
and dS math, the register-A products, the score products, the exchange's
barriers, the ring's wait for its consumers); their outputs are wrong by
design and are not checked.

``decode_attention`` (``--kernels decode``) runs its bf16 route at
qwen3-0.6b's decode shape (B 8, H 16/8, 32,768 keys, d 128) and at
gemma2-2b ``long_500k``'s global layer (B 1, H 8/4, 524,288 keys, d 256,
softcap 50), caches in the model's [B, S, Hkv, d] layout: the shipped
kernel without and with the ``lse`` output and with its float32 output
(the sequence-sharded decode's call), beside the same source before the
``lse`` output (``--parent-decode``, built here and called as its wrapper
called it). The parent's output and the shipped one with ``lse`` are held
to the shipped call's bit for bit, the float32 output rounded to bf16
too; then all four are timed in turns, and the profiler's device time of
each launch of ``decode_tc_kernel``.

``f32`` (``--kernels f32``) runs the float32 attention routes at
qwen3-0.6b's prefill shape (B 1, S 32,768, H 16/8, d 128) and at
granite-moe's (H 16/8, d 64), the model's strided layout: the
three-piece tensor-core route (``csrc/flash_f32_tc.cu``) beside the SIMT
kernel it replaced at these head dims (``chip_smoke.simt_flash``) and a
build of its source without ``FRESH_PV`` (each tile's P V accumulated into
O by the tensor cores, not in a fresh accumulator), each held to
``ATTN_TOL["float32"]`` against the plain version first, the shipped
route's output to a first call's bit for bit; then timed in turns with the
profiler's device time of ``flash32_kernel`` and of the split pre-pass.
Before that, on capped cases of the backward check's kind (q scaled by
c / 2, caps 20, 30 and 50; 9 draws at d = 64 and at 128, 18 at 256, 18 at
16 and at 32), the
largest error of the routes and of the plain float32 version against
float64, of the routes against the plain version, and of each route's
``chip_smoke.f32_err`` ratio (the float32 checks' rule).
Then the backward at qwen3-0.6b's training shape (B 8, S 2,048): the
route (``csrc/flash_bwd_f32_tc.cu``) beside ``chip_smoke.simt_bwd``, each
held to ``flash_bwd_bound``, timed in turns, with the device time of each
of its kernels. Then gemma2-2b's d = 256 (``d256_section``): the forward
at a global layer's prefill (B 1, H 8/4, S 32,768, softcap 50) and a
local one's (window 4,096), the backward at B 1, S 4,096, softcap 50,
each route beside the SIMT kernel and SDPA's float32 call (no softcap),
in turns, with its kernels' device times; and d = 16 and 32
(``small_d_rows``: forward at B 1, H 16/8, S 32,768, backward at B 8, S
2,048): the three-piece route beside the SIMT kernels, SDPA and, for the
forward, three builds of its plan at these dims (``f32_small_bk64``:
64-key tiles where the shipped plan takes 128; ``f32_small_six_pv``: P V
as six wgmmas a 16-key step; ``f32_small_producer``: a producer
warpgroup, ptxas's registers capped at 168), and the timing-only
``F32_PHASES`` (the split of P, the ex2s, P V or five of S's six products
cut; outputs wrong by design), with the plain versions' times, the
kernels' device times and the floors. With
``--parent-f32 DIR`` (a directory holding an earlier ``flash_f32_tc.cu``
and ``flash_bwd_f32_tc.cu``) the float32 routes at d = 64, 128 and 256
(B 1, S 4,096, windows 0 and 1,000, gemma2's softcap at d = 256) run
beside those sources' builds, called as the wrapper calls the shipped
libraries: output, lse and gradients bit for bit equal, then timed in
turns. With ``--parent-bf16 DIR`` (a directory holding an
earlier ``flash_tc.cu`` and ``flash_bwd_tc.cu``) the bf16 routes at
qwen3-0.6b's prefill and training shapes run beside those sources' builds,
called as the wrappers call the shipped libraries: outputs bit for bit
equal, then timed in turns (parent, shipped, shipped, parent). Last, the
``-Xptxas=-v`` lines of the float32 libraries and the variants.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
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


# the probe_sorted_many kernel this one replaced: one thread a probe, a
# full binary search of the keys, then a gallop (appended to rdf_kernels.cu
# as rdf_probe_sorted_old)
_OLD_PROBE = r"""
__device__ __forceinline__ int old_lower_bound(const int* __restrict__ keys,
                                               int n, int v) {
  int base = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    const bool right = __ldg(keys + base + half) < v;
    base = right ? base + half + 1 : base;
    len = right ? len - half - 1 : half;
  }
  return base;
}
__device__ __forceinline__ int old_upper_bound(const int* __restrict__ keys,
                                               int n, int v) {
  int base = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    const bool right = __ldg(keys + base + half) <= v;
    base = right ? base + half + 1 : base;
    len = right ? len - half - 1 : half;
  }
  return base;
}
__device__ __forceinline__ int old_upper_from(const int* __restrict__ keys,
                                              int n, int lo, int v) {
  int prev = lo, probe = lo;
  int64_t step = 1;
  while (probe < n && __ldg(keys + probe) <= v) {
    prev = probe + 1;
    probe = step < n - prev ? prev + static_cast<int>(step) : n;
    step <<= 1;
  }
  return prev + old_upper_bound(keys + prev, probe - prev, v);
}
__global__ void old_probe_kernel(const int* __restrict__ keys, int K,
                                 const int* __restrict__ probes, int64_t n,
                                 int* __restrict__ lo, int* __restrict__ hi) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x; i < n; i += stride) {
    const int v = probes[i];
    const int l = old_lower_bound(keys, K, v);
    lo[i] = l;
    hi[i] = old_upper_from(keys, K, l, v);
  }
}
int rdf_probe_sorted_old(const void* keys, int K, const void* probes,
                         int64_t n, void* lo, void* hi, void* stream) {
  old_probe_kernel<<<grid_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), K, static_cast<const int*>(probes), n,
      static_cast<int*>(lo), static_cast<int*>(hi));
  return static_cast<int>(cudaGetLastError());
}

"""
_ERROR_STRING = "const char* rdf_error_string(int code) {"

# the register route's projection, as the shipped source declares it
_PROJECT = ("__device__ __forceinline__ void project(float (&v)[KMAX],\n"
            "                                        const float (&e)[KMAX])"
            " {")
# an exact projection in its place: the threshold tau where the clipped sum
# phi(tau) = sum_k clip(v_k - tau, 0, 1) crosses 1, found from phi's
# breakpoints (v_k and v_k - 1 in [0, max v]): phi is linear between the
# largest breakpoint where it is above 1 and the smallest where it is not;
# the shipped projection stays beside it as project_bisect
_EXACT_PROJECT = _PROJECT + r"""
  float c[KMAX];
  float hi = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    v[k] = e[k] > 0.f ? v[k] : 0.f;
    c[k] = clip01(v[k]);
    hi = fmaxf(hi, v[k]);
  }
  const float s = tree_sum(c);
  float tau = 0.f;
  if (s > 1.f) {
    float a = 0.f, fa = s, z = hi, fz = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KMAX; ++j) {
      const float p = fminf(
          fmaxf(j < KMAX ? v[j] : v[j - KMAX] - 1.f, 0.f), hi);
#pragma unroll
      for (int k = 0; k < KMAX; ++k) c[k] = clip01(v[k] - p);
      const float fp = tree_sum(c);
      if (fp > 1.f) {
        if (p > a) a = p, fa = fp;
      } else if (p < z) {
        z = p, fz = fp;
      }
    }
    tau = a + (fa - 1.f) * (z - a) / (fa - fz);
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    v[k] = (s > 1.f ? clip01(v[k] - tau) : clip01(v[k])) * e[k];
}
template <int KMAX>
""" + _PROJECT.replace("project(", "project_bisect(")

# the 64 x 16 score product f32_bk16 needs, which the shipped plans do not
_WGMMA_SS16 = r"""template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

"""

# flash_f32_tc.cu's key tile and ring depth (Plan<D>), as shipped
_F32_PLAN = ("  static constexpr int BK = D < 64 ? 128 : D == 64 ? 64 : 32;  "
             "// keys a tile\n"
             "  static constexpr int STAGES = D < 64 ? 4 : D == 64 ? 3 : D == 128 "
             "? 2 : 1;")
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
    # the replaced probe_sorted_many kernel beside the shipped ones
    "probe_old": ("rdf_kernels.cu", [
        (_ERROR_STRING, _OLD_PROBE + _ERROR_STRING)]),
    # no run carried across chunks: each chunk's first and last runs are
    # added atomically, as a range's are
    "seg_nocarry": ("sparse_kernels.cu", [
        ("const int first_node = __ldg(dst + e_begin);",
         "int first_node = __ldg(dst + e_begin);"),
        ("const int last_node = __ldg(dst + e_end - 1);",
         "int last_node = __ldg(dst + e_end - 1);"),
        ("const bool have_carry = k > 0;", "const bool have_carry = false;"),
        ("const bool range_ends = k + 1 == n_chunks;",
         "const bool range_ends = true;\n"
         "    first_node = cd[0];\n    last_node = chunk_last_node;")]),
    # the register route's bisection runs all 40 steps
    "qad_noexit": ("qad_kernels.cu", [
        ("    if (!again) break;\n", "")]),
    # a vote before every bisection step, its latency on the step's chain
    "qad_vote1": ("qad_kernels.cu", [
        ("  for (int it = 0; it < kBisect; it += 2) {\n"
         "    const float lo0 = lo, hi0 = hi;\n",
         "  for (int it = 0; it < kBisect; ++it) {\n"
         "    if (!__any_sync(kFull, moving)) break;\n"
         "    const float lo0 = lo, hi0 = hi;\n"),
        ("    const bool again = __any_sync(kFull, moving);\n"
         "    bisect_step(v, lo, hi);\n"
         "    if (!again) break;\n", "")]),
    # the register route with an exact projection for the bisection
    "qad_exact": ("qad_kernels.cu", [(_PROJECT, _EXACT_PROJECT)]),
    # the d = 256 backward without the exchange: each warpgroup takes the
    # whole S^T and dP^T (S and dP) tile over all of d, as the forward does
    "bwd_whole": ("flash_bwd_tc.cu", [
        ("  static constexpr bool EXCHANGE = SPLIT_COLS;",
         "  static constexpr bool EXCHANGE = false;")]),
    # the float32 forward with each tile's P V accumulated into O by the
    # tensor cores
    "f32_no_fresh_pv": ("flash_f32_tc.cu", [
        ("  static constexpr bool FRESH_PV = true;",
         "  static constexpr bool FRESH_PV = false;")]),
    # the float32 forward at d = 256 on the other plan that fits its shared
    # memory: two stages of 16-key K and V tiles (S a 64 x 16 wgmma)
    "f32_bk16": ("flash_f32_tc.cu", [
        (_F32_PLAN, "  static constexpr int BK = D < 64 ? 128 : D == 64 ? 64 "
                    ": D == 128 ? 32 : 16;\n"
                    "  static constexpr int STAGES = D < 64 ? 4 : D == 64 ? 3 "
                    ": 2;"),
        ("template <>\n__device__ __forceinline__ void wgmma_ss<32>(",
         _WGMMA_SS16 + "template <>\n"
         "__device__ __forceinline__ void wgmma_ss<32>(")]),
    # the float32 forward at d = 16 and 32 with 64-key tiles (the shipped
    # plan takes 128): half the score and split registers, twice the tiles
    "f32_small_bk64": ("flash_f32_tc.cu", [
        (_F32_PLAN, "  static constexpr int BK = D <= 64 ? 64 : 32;  "
                    "// keys a tile\n"
                    "  static constexpr int STAGES = D < 64 ? 4 : D == 64 ? 3 "
                    ": D == 128 ? 2 : 1;")]),
    # the float32 forward at d = 16 and 32 with P V as six wgmmas a 16-key
    # step at N = d, as at d = 64, where the shipped plan takes three (one
    # a piece of P over V's pieces side by side)
    "f32_small_six_pv": ("flash_f32_tc.cu", [
        ("  static constexpr bool MERGED_PV = D < 64;",
         "  static constexpr bool MERGED_PV = false;")]),
    # ... with a producer warpgroup, as at d >= 64 (three warpgroups: ptxas
    # caps the registers at 168)
    "f32_small_producer": ("flash_f32_tc.cu", [
        ("  static constexpr bool PRODUCER = D >= 64;",
         "  static constexpr bool PRODUCER = true;")]),
    # timing only, outputs wrong by design: the float32 forward with one
    # phase cut, to read what each costs at d = 16 and 32
    "f32_no_split": ("flash_f32_tc.cu", [       # P as its hi piece alone
        ("            split2(p0, p1, pp[0][kk][2 * half + r], "
         "pp[1][kk][2 * half + r],\n                   pp[2][kk][2 * half + r]);",
         "            pp[0][kk][2 * half + r] =\n"
         "                bf16x2_bits(__floats2bfloat162_rn(p0, p1));\n"
         "            pp[1][kk][2 * half + r] = pp[2][kk][2 * half + r] = 0u;")]),
    "f32_no_exp": ("flash_f32_tc.cu", [         # no ex2
        ("            const float p0 = ex2(fmaf(s[at], f, -m_use[r]));\n"
         "            const float p1 = ex2(fmaf(s[at + 1], f, -m_use[r]));",
         "            const float p0 = fmaf(s[at], f, -m_use[r]);\n"
         "            const float p1 = fmaf(s[at + 1], f, -m_use[r]);")]),
    "f32_no_pv": ("flash_f32_tc.cu", [          # no P V products
        ("        for (int kk = 0; kk < BK / 16; ++kk) {\n"
         "          const uint64_t at = vd + ((kk * 16 * SWZ) >> 4);",
         "        for (int kk = 0; kk < 0; ++kk) {\n"
         "          const uint64_t at = vd + ((kk * 16 * SWZ) >> 4);")]),
    "f32_one_s": ("flash_f32_tc.cu", [          # S as one piece product
        ("  for (int t = 0; t < 6; ++t)\n#pragma unroll\n"
         "    for (int c = 0; c < P::NC; ++c)",
         "  for (int t = 0; t < 1; ++t)\n#pragma unroll\n"
         "    for (int c = 0; c < P::NC; ++c)")]),
    # the d = 256 backward with d <= 128's block order: the (head, batch)
    # pairs one after another, the longest tiles first within each
    "bwd_head_major": ("flash_bwd_tc.cu", [
        ("  static constexpr bool TILE_MAJOR = SPLIT_COLS;",
         "  static constexpr bool TILE_MAJOR = false;")]),
    # timing only, outputs wrong by design: the backward with one phase
    # taken out, to read what each phase costs
    "bwd_no_math": ("flash_bwd_tc.cu", [       # P and dS: a select each
        ("    float p, f = 1.f;\n    if (capped) {",
         "    s = live ? s : 0.f;\n    dp = live ? dp * delta : 0.f;\n"
         "    return;\n    float p, f = 1.f;\n    if (capped) {")]),
    "bwd_no_rs": ("flash_bwd_tc.cu", [         # dV, dK and dQ's products
        ("  for (int part = 0; part < 2; ++part)",
         "  for (int part = 0; part < 0; ++part)")]),
    "bwd_no_ss": ("flash_bwd_tc.cu", [         # S and dP's products
        ("  for (int c = 0; c < (P::EXCHANGE ? P::OWN : P::NC); ++c)",
         "  for (int c = 0; c < 0; ++c)")]),
    "bwd_no_bar": ("flash_bwd_tc.cu", [        # the exchange's barriers
        ('  asm volatile("bar.sync 1, 256;\\n" ::: "memory");', "")]),
    "bwd_no_empty_wait": ("flash_bwd_tc.cu", [  # refills wait for no one
        ("      mbar_wait(empty((i - 1) % kStages), ((i - 1) / kStages) & 1);"
         "\n      load(i - 1 + kStages);\n    }\n    __syncwarp();  // warp 0"
         " whole again before its wgmma\n    const int st = i % kStages;\n"
         "    const uint32_t parity = (i / kStages) & 1;\n    const int q0",
         "      load(i - 1 + kStages);\n    }\n    __syncwarp();  // warp 0"
         " whole again before its wgmma\n    const int st = i % kStages;\n"
         "    const uint32_t parity = (i / kStages) & 1;\n    const int q0"),
        ("      mbar_wait(empty((i - 1) % kStages), ((i - 1) / kStages) & 1);"
         "\n      load(i - 1 + kStages);",
         "      load(i - 1 + kStages);")]),
}
# the timing-only builds above
BWD_PHASES = ("bwd_no_math", "bwd_no_rs", "bwd_no_ss", "bwd_no_bar",
              "bwd_no_empty_wait")
F32_PHASES = ("f32_no_split", "f32_no_exp", "f32_no_pv", "f32_one_s")
SECTIONS = ("bag", "scan", "segment", "probe", "qad", "bwd", "decode",
            "f32")
# the sections run when none is named: decode times an earlier build of
# its source, which a checkout does not hold, so it runs only when named
DEFAULT_SECTIONS = tuple(s for s in SECTIONS if s != "decode")


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


def build_variants(nvcc_flags: list[str], nvcc: str,
                   names) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        if name not in names:
            continue
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
        BUILD_LOGS[name] = text
        libs[name] = ctypes.CDLL(str(lib))
    return libs


BUILD_LOGS: dict[str, str] = {}   # nvcc's output of each variant built


def tc_variant(lib, q, k, v, o, dout, lse, softcap: float):
    """(dq, dk, dv) of ``flash_attention_bwd``'s tensor-core route through
    ``lib``, a variant build of ``csrc/flash_bwd_tc.cu``, called as the
    wrapper calls the shipped library (no window; q, k, v and dout as TMA
    reads them)."""
    import torch
    from repro_torch.kernels.flash_attention import ROW_PAD, strides
    B, H, S, d = q.shape
    Sp = -(-S // ROW_PAD) * ROW_PAD
    rows = torch.empty((2, B, H, Sp), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rc = lib.bwd_tc_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), rows.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides(q, k, v, o, dout, dq, dk, dv),
        B, H, k.shape[1], S, Sp, d, 0, softcap, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd variant: CUDA launch "
                           f"failed ({rc})")
    return dq, dk, dv


# the variants each section builds
SECTION_VARIANTS = {"bag": ("bag_nohint", "bag_evictlast"),
                    "scan": ("probe_noshortcut",),
                    "segment": ("seg_nocarry",), "probe": ("probe_old",),
                    "qad": ("qad_noexit", "qad_vote1", "qad_exact"),
                    "bwd": ("bwd_whole", "bwd_head_major", *BWD_PHASES),
                    "decode": (),
                    "f32": ("f32_no_fresh_pv", "f32_bk16", "f32_small_bk64",
                            "f32_small_six_pv", "f32_small_producer",
                            *F32_PHASES)}
# the parent's decode_tc.cu argument types: q, k, v, lengths, o, part,
# tickets, strides, B, H, Hkv, S, D, chunk, window, softcap, scale, stream
_PARENT_DECODE = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
    [ctypes.c_float] * 2 + [ctypes.c_void_p]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(DEFAULT_SECTIONS),
                    help=f"comma-separated sections of {SECTIONS} (by "
                         f"default all but decode, which needs "
                         f"--parent-decode)")
    ap.add_argument("--parent-decode", type=Path,
                    default=OUT.parent / "parent" / "decode_tc.cu",
                    help="the decode section's earlier csrc/decode_tc.cu "
                         "(before the lse output)")
    ap.add_argument("--parent-bf16", type=Path, default=None,
                    help="the f32 section's directory of an earlier "
                         "flash_tc.cu and flash_bwd_tc.cu, built and timed "
                         "beside the shipped bf16 routes")
    ap.add_argument("--parent-f32", type=Path, default=None,
                    help="the f32 section's directory of an earlier "
                         "flash_f32_tc.cu and flash_bwd_f32_tc.cu, built "
                         "and held bit for bit to the shipped float32 "
                         "routes at d = 64, 128 and 256")
    args = ap.parse_args([] if argv is None else argv)
    sections = args.kernels.split(",")
    if not set(sections) <= set(SECTIONS):
        ap.error(f"--kernels takes {SECTIONS}")
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: CUDA is not available", file=sys.stderr)
        return 1
    if "decode" in sections and not args.parent_decode.is_file():
        ap.error(f"--parent-decode {args.parent_decode}: no such file")
    sys.path.insert(0, str(REPO / "src"))
    import chip_smoke as smoke
    from repro_torch.configs.registry import get_spec
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.embedding_bag import (BAG_THREADS, bag_plan,
                                                   embedding_bag)
    from repro_torch.kernels.join_probe import (probe_plan, probe_sorted_many,
                                                scan_probe)
    from repro_torch.kernels.segment_mp import (seg_ranges, seg_smem_bytes,
                                                segment_plan,
                                                segment_sum_sorted)
    from repro_torch.models.recsys import _field_ids
    from repro_torch.rdf.generator import generate_watdiv_like
    from repro_torch.sparql.engine import TorchBackend

    t0 = time.perf_counter()
    _build.build("sparse", "rdf", "qad", "flash", "bwd", "bwd_tc", "decode",
                 "attn", "flash32", "bwd32")
    libs = build_variants(_build.NVCC_FLAGS, _build._nvcc(),
                          {v for sec in sections
                           for v in SECTION_VARIANTS[sec]})
    if "decode" in sections:
        OUT.mkdir(parents=True, exist_ok=True)
        lib = OUT / "libdecode_parent.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(args.parent_decode)], check=True,
                       capture_output=True)
        libs["decode_parent"] = ctypes.CDLL(str(lib))
        libs["decode_parent"].decode_decode_attention.argtypes = \
            _PARENT_DECODE
    libs["bag"] = libs["seg"] = _build.library("sparse")
    libs["probe"] = _build.library("rdf")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, lib in libs.items():
        if name.startswith("bag"):
            lib.sparse_embedding_bag.argtypes = \
                [P, P, P, P, I, L, I, I, I, I, I, I, I, I, P]
        elif name.startswith("seg"):
            lib.sparse_segment_sum_sorted.argtypes = \
                [P, P, P, P, I, L, I, I, L, I, I, I, I, I, I, I, P]
        elif name.startswith("probe"):
            lib.rdf_scan_probe.argtypes = \
                [P, L, I, I, I, P, I, I, I, I, I, I, P, P, P, P, P]
            lib.rdf_probe_sorted_many.argtypes = \
                [P, I, P, L, I, I, I, I, P, P, P, P]
    if "probe_old" in libs:
        libs["probe_old"].rdf_probe_sorted_old.argtypes = \
            [P, I, P, L, P, P, P]
    for name in SECTION_VARIANTS["qad"]:
        if name in libs:
            libs[name].qad_qad_solve.argtypes = [P] * 7 + [I] * 8 + [P]
    for name in SECTION_VARIANTS["bwd"]:
        if name in libs:
            libs[name].bwd_tc_flash_attention_bwd.argtypes = \
                _build.LIBRARIES["bwd_tc"][1]["flash_attention_bwd"] + [P]
    for name in SECTION_VARIANTS["f32"]:
        if name in libs:
            libs[name].flash32_flash_attention.argtypes = \
                _build.LIBRARIES["flash32"][1]["flash_attention"] + [P]
    parents = []
    if "f32" in sections and args.parent_bf16 is not None:
        parents += [("flash", args.parent_bf16 / "flash_tc.cu"),
                    ("bwd_tc", args.parent_bf16 / "flash_bwd_tc.cu")]
    if "f32" in sections and args.parent_f32 is not None:
        parents += [("flash32", args.parent_f32 / "flash_f32_tc.cu"),
                    ("bwd32", args.parent_f32 / "flash_bwd_f32_tc.cu")]
    for lib, src in parents:
        out = OUT / f"lib{lib}_parent.so"
        OUT.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True, capture_output=True)
        handle = ctypes.CDLL(str(out))
        kernel = "flash_attention_bwd" if lib.startswith("bwd") else \
            "flash_attention"
        getattr(handle, f"{lib}_{kernel}").argtypes = \
            _build.LIBRARIES[lib][1][kernel] + [P]
        libs[f"{lib}_parent"] = handle
    gpu = smoke.gpu_line()
    log(f"build {time.perf_counter() - t0:.1f} s; {gpu}")
    dev = torch.device("cuda")
    times: dict[str, float] = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_in_turns(label, order, want, calls, exact=None):
        """Each variant's output against ``want`` bit for bit (only those
        named in ``exact``, when given), then the variants timed in turns,
        forward and backward."""
        for name, fn in order:
            if exact is not None and name not in exact:
                continue
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
    if "bag" in sections:
        cfg = get_spec(smoke.RECSYS_ARCH).config
        data = smoke._recsys_inputs(cfg, 262_144, 2, dev)
        ids = _field_ids(data["ids"], cfg.vocab_per_field)
        mask = data["id_mask"]
        B, F, NNZ = ids.shape
        D = cfg.embed_dim
        table = torch.randn(
            (cfg.n_sparse * cfg.vocab_per_field, D),
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
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

    # -------------------------------------------- scan_probe and the keys
    if "scan" in sections or "probe" in sections:
        t0 = time.perf_counter()
        gen = generate_watdiv_like(scale=1000, seed=0)
        backend = TorchBackend(device=dev)
        follows = gen.dictionary.predicate_id("follows")
        real = (backend._triples(gen.store),
                backend._pred_views(gen.store, follows)[0][0])
        T, K = real[0].shape[0], real[1].shape[0]
        log(f"WatDiv-like scale 1000: T={T} K={K} in "
            f"{time.perf_counter() - t0:.1f} s")
    if "scan" in sections:
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
                ("scalar row loads",
                 lambda: probe("probe", rows, keys, vec=0)),
            ]
            run_in_turns(f"scan_probe {label}", order, want, calls=20)
            del want
    # --------------------------------------------------- probe_sorted_many
    if "probe" in sections:
        keys = real[1]
        tids = torch.from_numpy(gen.store.pred_tids(follows)).to(dev)
        objects = real[0][tids, 2].contiguous()
        inside = float(((objects >= keys[0]) & (objects <= keys[-1]))
                       .float().mean())
        log(f"probe_sorted_many: {inside} of the K = P probes lie inside "
            f"the keys' range (each takes a search)")
        for label, probes in (("K=P", objects[None, :]),
                              ("n=4000", objects[None, :4000].clone())):
            n = probes.numel()
            want = ref.probe_sorted_reference(keys, probes)
            if smoke.max_abs_err(probe_sorted_many(keys, probes), want):
                raise AssertionError(f"probe_sorted_many {label}: differs")

            def probe_many(stride, probes=probes, n=n):
                plan = probe_plan(n, K, True)
                n_samples = -(-K // stride)
                sample = torch.empty(n_samples, dtype=torch.int32,
                                     device=dev)
                lo, hi = (torch.empty(probes.shape, dtype=torch.int32,
                                      device=dev) for _ in range(2))
                rc = libs["probe"].rdf_probe_sorted_many(
                    keys.data_ptr(), K, probes.data_ptr(), n, stride,
                    n_samples, 1, plan.blocks, sample.data_ptr(),
                    lo.data_ptr(), hi.data_ptr(), stream())
                if rc:
                    raise RuntimeError(f"probe variant: CUDA error {rc}")
                return lo, hi

            def probe_old(probes=probes, n=n):
                lo, hi = (torch.empty(probes.shape, dtype=torch.int32,
                                      device=dev) for _ in range(2))
                rc = libs["probe_old"].rdf_probe_sorted_old(
                    keys.data_ptr(), K, probes.data_ptr(), n, lo.data_ptr(),
                    hi.data_ptr(), stream())
                if rc:
                    raise RuntimeError(f"old probe kernel: CUDA error {rc}")
                return lo, hi

            log(f"probe_sorted_many {label}: shipped plan "
                f"{probe_plan(n, K, True)}")
            order = [
                ("shipped", lambda probes=probes:
                 probe_sorted_many(keys, probes)),
                ("the replaced kernel", probe_old),
                ("full 32K sample", lambda: probe_many(-(-K // 32768))),
                ("sample 8192", lambda: probe_many(-(-K // 8192))),
                ("sample 1024", lambda: probe_many(-(-K // 1024))),
            ]
            run_in_turns(f"probe_sorted_many {label}", order, want,
                         calls=20)
            # events over back-to-back calls read the host's time a call
            # here; the profiler reads the card's
            for name, fn, kernels in (
                    ("shipped", order[0][1],
                     ("probe_sorted_kernel", "gather_sample_kernel")),
                    ("the replaced kernel", probe_old, ("old_probe_kernel",))):
                ms = sum(smoke.kernel_device_ms(fn, k)[0] for k in kernels)
                times[f"probe_sorted_many {label} {name} device"] = ms
                log(f"probe_sorted_many {label} {name} device: {ms} ms")
            del want

        # the cold batch's launches (the device route's joins), the shipped
        # kernel beside the replaced one put behind the same wrapper
        from repro_torch.kernels import join_probe
        from repro_torch.sparql.endpoint import SparqlEndpoint
        from repro_torch.sparql.engine import QueryEngine
        texts = smoke.query_mix(gen, 24, seed=1)
        ep = SparqlEndpoint(gen.store, gen.dictionary, engine=QueryEngine(
            backend=backend, max_rows=5_000_000))
        ep.query_many(texts)                   # stages the store's views
        shipped = join_probe.probe_sorted_many

        def replaced(keys, probes):
            lo, hi = (torch.empty(probes.shape, dtype=torch.int32,
                                  device=dev) for _ in range(2))
            if probes.numel():
                rc = libs["probe_old"].rdf_probe_sorted_old(
                    keys.data_ptr(), keys.shape[0], probes.data_ptr(),
                    probes.numel(), lo.data_ptr(), hi.data_ptr(), stream())
                if rc:
                    raise RuntimeError(f"old probe kernel: CUDA error {rc}")
            return lo, hi

        track = ("probe_sorted_kernel", "old_probe_kernel",
                 "gather_sample_kernel")
        for rnd, name in enumerate(("shipped", "the replaced kernel",
                                    "the replaced kernel", "shipped")):
            join_probe.probe_sorted_many = (shipped if name == "shipped"
                                            else replaced)
            try:
                prof = smoke.device_profile(
                    lambda: smoke._steady_cold(ep, texts), track=track)
            finally:
                join_probe.probe_sorted_many = shipped
            for k, (ms, n) in prof["tracked"].items():
                times[f"cold batch {name} {k} [{rnd}]"] = ms
            log(f"cold batch, {name} [{rnd}]: [device ms, launches] "
                f"{json.dumps(prof['tracked'])}; batch {prof['wall_ms']} ms")

    # -------------------------------------------------- segment_sum_sorted
    if "segment" in sections:
        shape = get_spec(smoke.GNN_ARCH).shapes["ogb_products"]
        N = shape["n_nodes"]
        graph = smoke.gnn_graph(N, shape["n_edges"], 1, 0, dev)
        dst = graph["edges"][:, 1].contiguous()
        del graph
        E = dst.shape[0]
        gen_t = torch.Generator(device=dev).manual_seed(3)

        def seg(lib, msg, stages=None, grid=None, ring=True):
            """The shipped plan with its stages, grid or route replaced."""
            D = msg.shape[1]
            plan = segment_plan(E, D, 4, True)
            stages = stages or (plan.stages if ring else 1)
            smem = seg_smem_bytes(stages, plan.chunk, D, 4)
            grid = grid or 132 * min(3, 228 * 1024 // (smem + 1024))
            per, blocks = seg_ranges(E, 4, grid)
            plan = plan._replace(stages=stages, ring=ring, smem=smem,
                                 per=per, blocks=blocks)
            out = torch.empty((N, D), device=dev)
            rc = libs[lib].sparse_segment_sum_sorted(
                msg.data_ptr(), dst.data_ptr(), out.data_ptr(), None, 0, E,
                D, N, plan.per, plan.chunk, plan.sub, plan.n_sub, plan.cols,
                plan.stages, int(plan.ring), plan.blocks, stream())
            if rc:
                raise RuntimeError(f"segment variant: CUDA error {rc}")
            return out

        for D in (16, 7, 1):
            # integer-valued: every order of the sums gives the same bits
            msg = torch.randint(-2, 3, (E, D), generator=gen_t, device=dev,
                                dtype=torch.float32)
            want = segment_sum_sorted(msg, dst, N)
            log(f"segment_sum_sorted D={D}: shipped plan "
                f"{segment_plan(E, D, 4, True)}")
            order = [
                ("shipped", lambda msg=msg: segment_sum_sorted(msg, dst, N)),
                ("ring off (the scalar route, 16-byte loads)",
                 lambda msg=msg: seg("seg", msg, ring=False)),
                ("3 stages (2 blocks an SM)",
                 lambda msg=msg: seg("seg", msg, stages=3)),
                ("4 stages (1 block an SM)",
                 lambda msg=msg: seg("seg", msg, stages=4)),
                ("2 blocks an SM", lambda msg=msg: seg("seg", msg, grid=264)),
                ("1 block an SM", lambda msg=msg: seg("seg", msg, grid=132)),
                ("no run carry (atomics a chunk)",
                 lambda msg=msg: seg("seg_nocarry", msg)),
            ]
            run_in_turns(f"segment_sum_sorted D={D}", order, want, calls=10)
            del msg, want
            torch.cuda.empty_cache()
    # ------------------------------------------------------------ qad_solve
    if "qad" in sections:
        from repro_torch.kernels.qad_solve import (ROUTES, generic_plan,
                                                   qad_plan, qad_solve,
                                                   unpack)
        libs["qad"] = _build.library("qad")
        iters = smoke.QAD_ITERS
        shapes = [(21, 4, 4, 0)] + [s for s in smoke.QAD_SEEDED
                                    if qad_plan(s[0], s[1]).route
                                    == "register"]
        for N, K, B, seed in shapes:
            A, b, F, e, fm, Ds = (torch.from_numpy(x).to(dev) for x in
                                  smoke.qad_instance(N, K, B, seed))
            plan = qad_plan(N, K)

            def variant(lib, plan=plan, A=A, b=b, F=F, e=e, fm=fm, Ds=Ds):
                n, k = A.shape
                out = torch.empty((Ds.shape[0], n * k + 2), device=dev)
                rc = libs[lib].qad_qad_solve(
                    A.data_ptr(), b.data_ptr(), F.data_ptr(), e.data_ptr(),
                    fm.data_ptr(), Ds.data_ptr(), out.data_ptr(),
                    Ds.shape[0], n, k, iters, ROUTES.index(plan.route),
                    plan.kmax, plan.threads, plan.smem_bytes, stream())
                if rc:
                    raise RuntimeError(f"qad variant {lib}: CUDA error {rc}")
                return out

            args = (A, b, F, e, fm, Ds, iters)
            label = f"qad_solve B={B} N={N} K={K}"
            log(f"{label}: shipped plan {plan}, generic "
                f"{generic_plan(N, K)}")
            order = [
                ("shipped (register route)", lambda args=args:
                 qad_solve(*args)),
                ("generic route", lambda variant=variant, N=N, K=K:
                 variant("qad", generic_plan(N, K))),
                ("no early exit", lambda variant=variant:
                 variant("qad_noexit")),
                ("a vote every step", lambda variant=variant:
                 variant("qad_vote1")),
                ("exact projection", lambda variant=variant:
                 variant("qad_exact")),
            ]
            want = order[0][1]()
            plain = unpack(ref.qad_solve_reference(*args).cpu(), N, K)
            for name, fn in order:
                err = smoke.qad_errors(unpack(fn().cpu(), N, K), plain, 0.0)
                log(f"{label} {name} vs plain: {json.dumps(err)}")
                times[f"{label} {name} d_err"] = err["d_err"]
            run_in_turns(label, order, want, calls=10,
                         exact=[name for name, _ in order if name not in (
                             "generic route", "exact projection")])
            for name, fn in order:
                kernel = ("qad_solve_kernel" if name == "generic route"
                          else "qad_reg_kernel")
                ms, n = smoke.kernel_device_ms(fn, kernel)
                times[f"{label} {name} device"] = ms
                log(f"{label} {name} device: {ms} ms ({n} launches "
                    f"recorded)")
        # B&B on R-QAD on a seeded instance of the round's shape (N = 21
        # users, K = 4 edges, tests/test_scheduler.py's recipe): the
        # shipped route beside the generic route put behind the same
        # wrapper, and the marginal bound, in turns; then the device's
        # busy share of one B&B on the shipped route
        from repro_torch.core import cost
        from repro_torch.core.bnb import branch_and_bound
        from repro_torch.kernels import qad_solve as qad_mod
        rng = np.random.default_rng(1)
        params = cost.SystemParams.synthetic(21, 4, seed=1)
        tasks = cost.QueryTasks(
            c=rng.uniform(1e7, 5e8, 21), w=rng.uniform(1e5, 5e7, 21),
            e=(rng.random((21, 4)) < 0.7).astype(float) * params.assoc)
        shipped_plan = qad_mod.qad_plan

        def bnb(bound, plan=shipped_plan):
            qad_mod.qad_plan = plan
            try:
                t0 = time.perf_counter()
                res = branch_and_bound(tasks, params, bound=bound,
                                       device=dev)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3, res
            finally:
                qad_mod.qad_plan = shipped_plan

        runs = {"rqad, register route": ("rqad", shipped_plan),
                "rqad, generic route": ("rqad", generic_plan),
                "marginal": ("marginal", shipped_plan)}
        base = bnb("marginal")[1]
        ms = {name: [] for name in runs}
        for rnd in range(6):
            for name in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
                t, res = bnb(*runs[name])
                if not (res.optimal and np.array_equal(res.D, base.D)
                        and math.isclose(res.objective, base.objective,
                                         rel_tol=1e-9)):
                    raise AssertionError(f"bnb {name}: {res.objective} "
                                         f"against {base.objective}")
                ms[name].append(t)
                if rnd == 0:
                    log(f"bnb {name}: {res.nodes_explored} expansions, "
                        f"objective {res.objective}")
        for name, ts in ms.items():
            times[f"bnb 21x4 {name}"] = statistics.median(ts)
            log(f"bnb 21x4 {name}: median {statistics.median(ts)} ms of "
                f"{ts}")
        prof = smoke.device_profile(lambda: bnb("rqad"),
                                    track=("qad_reg_kernel",))
        times["bnb 21x4 rqad busy share"] = prof["busy_share"]
        log(f"bnb 21x4 rqad under the profiler: wall {prof['wall_ms']} ms, "
            f"device {prof['device_ms']} ms, busy {prof['busy_share']}, "
            f"qad_reg_kernel [ms, launches] "
            f"{prof['tracked']['qad_reg_kernel']}")
        for line in _build.build_log("qad").splitlines():
            log(f"ptxas: {line.strip()}")
    # ------------------------------------------------ flash_attention_bwd
    if "bwd" in sections:
        from repro_torch.kernels.flash_attention import (flash_attention,
                                                         flash_attention_bwd)
        qwen, gemma = (get_spec(a).config for a in (smoke.LM_ARCH,
                                                     "gemma2-2b"))
        shapes = [(smoke.TRAIN_BATCH, smoke.TRAIN_SEQ, qwen, 0.0),
                  (1, 4096, gemma, gemma.attn_softcap)]
        for B, S, cfg, cap in shapes:
            H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
            gen = torch.Generator(device=dev).manual_seed(19)
            q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d,
                                         torch.bfloat16, dev)
            dout = torch.randn((B, S, H, d), generator=gen, device=dev,
                               dtype=torch.bfloat16).transpose(1, 2)
            lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            o = flash_attention(q, k, v, softcap=cap, lse=lse)
            label = (f"flash_attention_bwd B={B} H={H}/{Hkv} S={S} d={d} "
                     f"softcap={cap} bf16")
            order = [("tensor-core route",
                      lambda: flash_attention_bwd(q, k, v, o, dout, lse, 0,
                                                  cap)),
                     ("SIMT route",
                      lambda: smoke.simt_bwd(q, k, v, o, dout, lse, 0,
                                             cap))]
            for name in ("bwd_head_major", "bwd_whole"):
                if d == 256 and name in libs:
                    order.insert(1, (name, lambda lib=libs[name]: tc_variant(
                        lib, q, k, v, o, dout, lse, cap)))
            want = ref.flash_attention_backward_reference(q, k, v, dout, 0,
                                                          cap)
            bound = smoke.flash_bwd_bound(q, k, v, o, dout, want, 0, cap)
            for name, fn in order:
                err, ratio = smoke.bwd_err(fn(), want, bound)
                times[f"{label} {name} bound ratio"] = ratio
                log(f"{label} {name}: max abs err {err}, {ratio}x "
                    f"flash_bwd_bound")
                if not ratio <= 1.0:
                    raise AssertionError(f"{label} {name}: {ratio}x the "
                                         f"bound")
            del want, bound
            torch.cuda.empty_cache()
            # the tensor-core route's output against a first call's, bit
            # for bit (no atomics), then both routes timed in turns
            run_in_turns(label, order, order[0][1](), calls=3,
                         exact=["tensor-core route"])
            for name, fn in order[:-1]:      # the tensor-core kernels
                for kernel in ("rows_tc_kernel", "dkdv_tc_kernel",
                               "dq_tc_kernel"):
                    ms, n = smoke.kernel_device_ms(fn, kernel, calls=5)
                    times[f"{label} {name} {kernel} device"] = ms
                    log(f"{label} {name} {kernel} device: {ms} ms ({n} "
                        f"launches recorded)")
            for name in BWD_PHASES:   # timing only: outputs are wrong
                if d == 256 and name in libs:
                    for kernel in ("dkdv_tc_kernel", "dq_tc_kernel"):
                        ms, n = smoke.kernel_device_ms(
                            lambda lib=libs[name]: tc_variant(
                                lib, q, k, v, o, dout, lse, cap),
                            kernel, calls=5)
                        times[f"{label} {name} {kernel} device"] = ms
                        log(f"{label} {name} (timing only) {kernel} "
                            f"device: {ms} ms ({n} launches recorded)")
            del q, k, v, o, dout, lse, order
            torch.cuda.empty_cache()
        for line in _build.build_log("bwd_tc").splitlines():
            log(f"ptxas: {line.strip()}")
        for name in SECTION_VARIANTS["bwd"]:
            for line in BUILD_LOGS.get(name, "").splitlines():
                log(f"ptxas ({name}): {line.strip()}")
    # ------------------------------------- decode_attention, parent build
    if "decode" in sections:
        from repro_torch.kernels.decode_attention import (decode_attention,
                                                          split_plan)
        from repro_torch.kernels.flash_attention import strides
        tickets = torch.zeros(1024, dtype=torch.int32, device=dev)

        def parent_decode(q, k, v, lengths, softcap):
            """The parent's kernel, called as its wrapper called it."""
            B, H, d = q.shape
            Hkv, S = k.shape[1], k.shape[2]
            chunk, n_split = split_plan(B, Hkv, S, d)
            out = torch.empty_like(q)
            part = torch.empty(B * H * n_split * (d + 2),
                               dtype=torch.float32, device=dev)
            rc = libs["decode_parent"].decode_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                strides(q, k, v, out), B, H, Hkv, S, d, chunk, 0, softcap,
                d ** -0.5, stream())
            if rc:
                raise RuntimeError(f"parent decode_attention: CUDA error "
                                   f"{rc}")
            return out

        gen = torch.Generator(device=dev).manual_seed(0)
        for label, (B, H, Hkv, S, d, cap) in (
                ("decode qwen3-0.6b", (8, 16, 8, 32768, 128, 0.0)),
                ("decode long_500k global layer",
                 (1, 8, 4, 524288, 256, 50.0))):
            q = torch.randn((B, H, d), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            k, v = (torch.randn((B, S, Hkv, d), generator=gen, device=dev,
                                dtype=torch.bfloat16).transpose(1, 2)
                    for _ in range(2))
            n = torch.full((B,), S, dtype=torch.int32, device=dev)
            lse = torch.empty((B, H), dtype=torch.float32, device=dev)
            want = decode_attention(q, k, v, n, 0, cap)
            unrounded = decode_attention(q, k, v, n, 0, cap, lse=lse,
                                         out_dtype=torch.float32)
            if not torch.equal(unrounded.to(torch.bfloat16), want):
                raise AssertionError(f"{label}: the float32 output rounded "
                                     f"differs from the bf16 one")
            order = [
                ("shipped", lambda: decode_attention(q, k, v, n, 0, cap)),
                ("shipped with lse", lambda: decode_attention(
                    q, k, v, n, 0, cap, lse=lse)),
                ("shipped with lse, float32 output",
                 lambda: decode_attention(q, k, v, n, 0, cap, lse=lse,
                                          out_dtype=torch.float32)),
                ("parent", lambda: parent_decode(q, k, v, n, cap)),
            ]
            run_in_turns(label, order, want, calls=20,
                         exact=["shipped", "shipped with lse", "parent"])
            for name, fn in order:
                ms, m = smoke.kernel_device_ms(fn, "decode_tc_kernel",
                                               calls=20)
                times[f"{label} {name} device"] = ms
                log(f"{label} {name} decode_tc_kernel device: {ms} ms ({m} "
                    f"launches recorded)")
            del q, k, v, want, unrounded, order
            torch.cuda.empty_cache()
    # ------------------------------------ float32 attention on the cores
    if "f32" in sections:
        f32_section(libs, smoke, times, run_in_turns, stream, dev)
    print(gpu)
    print(json.dumps({"gpu": gpu, "ms": times}))
    return 0


def f32_section(libs, smoke, times, run_in_turns, stream, dev) -> None:
    """The ``f32`` section (see the module's docstring)."""
    import torch
    from repro_torch.configs.registry import get_spec
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (
        ROW_PAD, flash_attention, flash_attention_bwd, split_pieces, strides)

    def tc32_variant(lib, q, k, v, window=0, softcap=0.0, lse=None):
        """The float32 forward through ``lib``, a variant or earlier build
        of ``csrc/flash_f32_tc.cu``, called as the wrapper calls it."""
        B, H, S, d = q.shape
        out = torch.empty_like(q)
        q3, k3, v3 = split_pieces(q, k, v)
        rc = lib.flash32_flash_attention(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), strides(out), B, H,
            k.shape[1], S, d, window, softcap, d ** -0.5, stream())
        if rc:
            raise RuntimeError(f"flash_attention f32 variant: CUDA error {rc}")
        return out

    def bwd32_variant(lib, q, k, v, o, dout, lse, window=0, softcap=0.0):
        """(dq, dk, dv) of the float32 backward through ``lib``, an
        earlier build of ``csrc/flash_bwd_f32_tc.cu``, called as the
        wrapper calls it."""
        B, H, S, d = q.shape
        Sp = -(-S // ROW_PAD) * ROW_PAD
        rows = torch.empty((2, B, H, Sp), dtype=torch.float32, device=dev)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        q3, k3, v3, do3 = split_pieces(q, k, v, dout)
        rc = lib.bwd32_flash_attention_bwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
            o.data_ptr(), dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            strides(o, dout, dq, dk, dv), B, H, k.shape[1], S, Sp, d,
            window, softcap, d ** -0.5, stream())
        if rc:
            raise RuntimeError(f"flash_attention_bwd f32 parent: CUDA error "
                               f"{rc}")
        return dq, dk, dv

    def bf16_flash(lib, q, k, v):
        """The bf16 forward through ``lib`` (``flash_tc.cu``'s library,
        shipped or earlier), called as the wrapper calls it."""
        B, H, S, d = q.shape
        out = torch.empty_like(q)
        rc = lib.flash_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            strides(q, k, v, out), B, H, k.shape[1], S, d, 0, 0.0,
            d ** -0.5, stream())
        if rc:
            raise RuntimeError(f"flash_attention (bf16): CUDA error {rc}")
        return out

    def bf16_bwd(lib, q, k, v, o, dout, lse):
        """The bf16 backward through ``lib`` (``flash_bwd_tc.cu``'s
        library, shipped or earlier), called as the wrapper calls it."""
        B, H, S, d = q.shape
        Sp = -(-S // ROW_PAD) * ROW_PAD
        rows = torch.empty((2, B, H, Sp), dtype=torch.float32, device=dev)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rc = lib.bwd_tc_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), rows.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            strides(q, k, v, o, dout, dq, dk, dv), B, H, k.shape[1], S, Sp,
            d, 0, 0.0, d ** -0.5, stream())
        if rc:
            raise RuntimeError(f"flash_attention_bwd (bf16): CUDA error {rc}")
        return dq, dk, dv

    # The float32 forward's error on capped cases of the backward check's
    # kind (q scaled by c / 2 as check_backward_cases scales it): 9 draws
    # at d = 64 and 128 each, 18 at d = 256, then 18 at d = 16 and at 32
    # (after the others, so their draws stay as they were). Each route's and
    # the plain
    # float32 version's largest error from float64 and the routes' from the
    # plain version, in units of ATTN_TOL's 1e-5, and the largest ratio of
    # chip_smoke.f32_err (the checks' rule) of each route
    gen = torch.Generator(device=dev).manual_seed(31)
    worst: dict = {}
    n = 0
    draws = [(d, G, win, cap) for d in (64, 128) for G in (1, 2, 4)
             for win, cap in ((0, 30.0), (100, 20.0), (0, 50.0))]
    draws += [(d, G, win, cap) for d in (256, 16, 32) for G in (1, 2, 4)
              for win, cap in ((0, 30.0), (100, 20.0), (0, 50.0),
                               (0, 50.0), (300, 50.0), (0, 20.0))]
    for d, G, win, cap in draws:
        B, H, Hkv, S = 1 + n % 2, 2 * G, 2, 125 + 87 * (n % 9)
        n += 1
        q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.float32,
                                     dev)
        q = q * (cap / 2)
        exact = smoke.f64_reference(q, k, v, win, cap)
        outs = {"plain": ref.mha_reference(q, k, v, True, win, cap),
                "tc32 route": flash_attention(q, k, v, window=win,
                                              softcap=cap),
                "SIMT route": smoke.simt_flash(q, k, v, win, cap)}
        if "f32_no_fresh_pv" in libs:
            outs["f32_no_fresh_pv"] = tc32_variant(
                libs["f32_no_fresh_pv"], q, k, v, win, cap)
        for name, o in outs.items():
            for against, want in (("float64", exact),
                                  ("plain", outs["plain"])):
                if name == "plain" and against == "plain":
                    continue
                key = f"d {d}: {name} vs {against}, cap {cap:g}"
                err = float((o.double() - want.double()).abs().max())
                worst[key] = max(worst.get(key, 0.0), err / 1e-5)
            if name != "plain":
                key = f"d {d}: {name} f32_err ratio"
                ratio = smoke.f32_err(o, outs["plain"], exact)[1]
                worst[key] = max(worst.get(key, 0.0), ratio)
    for key, ratio in worst.items():
        times[f"f32 capped cases {key}"] = ratio
        log(f"flash_attention f32, capped cases (q x c / 2): {key}: "
            f"{ratio}" + ("" if "ratio" in key else " x 1e-5"))

    gen = torch.Generator(device=dev).manual_seed(23)
    for arch in (smoke.LM_ARCH, smoke.MOE_ARCH):
        cfg = get_spec(arch).config
        B, S, H, Hkv, d = 1, 32768, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        label = f"flash_attention {arch} B={B} H={H}/{Hkv} S={S} d={d} f32"
        q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.float32,
                                     dev)
        order = [("tc32 route", lambda: flash_attention(q, k, v)),
                 ("SIMT route", lambda: smoke.simt_flash(q, k, v))]
        if "f32_no_fresh_pv" in libs:
            order.insert(1, ("f32_no_fresh_pv", lambda: tc32_variant(
                libs["f32_no_fresh_pv"], q, k, v)))
        want = ref.mha_reference(q, k, v)
        for name, fn in order:
            err, ratio = smoke.attn_err(fn(), want)
            times[f"{label} {name} tolerance ratio"] = ratio
            log(f"{label} {name}: max abs err {err}, {ratio}x ATTN_TOL")
            if not ratio <= 1.0:
                raise AssertionError(f"{label} {name}: {ratio}x ATTN_TOL")
        del want
        torch.cuda.empty_cache()
        run_in_turns(label, order, order[0][1](), calls=1,
                     exact=["tc32 route"])
        for kernel in ("flash32_kernel", "split_kernel"):
            ms, n = smoke.kernel_device_ms(order[0][1], kernel, calls=3)
            times[f"{label} {kernel} device"] = ms
            log(f"{label} {kernel} device: {ms} ms ({n} launches recorded)")
        del q, k, v, order
        torch.cuda.empty_cache()

    cfg = get_spec(smoke.LM_ARCH).config
    B, S, H, Hkv, d = (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ, cfg.n_heads,
                       cfg.n_kv_heads, cfg.d_head)
    label = f"flash_attention_bwd B={B} H={H}/{Hkv} S={S} d={d} f32"
    q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.float32, dev)
    dout = torch.randn((B, S, H, d), generator=gen,
                       device=dev).transpose(1, 2)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    o = flash_attention(q, k, v, lse=lse)
    order = [("tc32 route",
              lambda: flash_attention_bwd(q, k, v, o, dout, lse)),
             ("SIMT route", lambda: smoke.simt_bwd(q, k, v, o, dout, lse))]
    want = ref.flash_attention_backward_reference(q, k, v, dout)
    bound = smoke.flash_bwd_bound(q, k, v, o, dout, want)
    for name, fn in order:
        err, ratio = smoke.bwd_err(fn(), want, bound)
        times[f"{label} {name} bound ratio"] = ratio
        log(f"{label} {name}: max abs err {err}, {ratio}x flash_bwd_bound")
        if not ratio <= 1.0:
            raise AssertionError(f"{label} {name}: {ratio}x the bound")
    del want, bound
    torch.cuda.empty_cache()
    run_in_turns(label, order, order[0][1](), calls=3, exact=["tc32 route"])
    for kernel in ("split_kernel", "rows_kernel", "dkdv_kernel", "dq_kernel"):
        ms, n = smoke.kernel_device_ms(order[0][1], kernel, calls=5)
        times[f"{label} {kernel} device"] = ms
        log(f"{label} {kernel} device: {ms} ms ({n} launches recorded)")
    del q, k, v, o, dout, lse, order
    torch.cuda.empty_cache()

    d256_section(smoke, times, run_in_turns, gen, dev,
                 (lambda *a: tc32_variant(libs["f32_bk16"], *a))
                 if "f32_bk16" in libs else None)
    small_d_rows(
        smoke, times, run_in_turns, gen, dev,
        {name: (lambda *a, lib=libs[name]: tc32_variant(lib, *a))
         for name in ("f32_small_bk64", "f32_small_six_pv",
                      "f32_small_producer", *F32_PHASES) if name in libs})

    if "flash32_parent" in libs:
        # the float32 routes at d = 64, 128 and 256 against an earlier build
        # of their sources: output, lse and gradients bit for bit, then the
        # forward and the backward timed in turns (parent, shipped,
        # shipped, parent)
        for pd, ph, pkv, cap in ((64, 16, 8, 0.0), (128, 16, 8, 0.0),
                                 (256, 8, 4, 50.0)):
            for win in (0, 1000):
                pb, ps = 1, 4096
                q, k, v = smoke._attn_inputs(gen, pb, ph, pkv, ps, pd,
                                             torch.float32, dev)
                label = (f"flash_attention B={pb} H={ph}/{pkv} S={ps} d={pd} "
                         f"window={win} softcap={cap:g} f32")
                lse, lse_p = (torch.empty((pb, ph, ps), device=dev)
                              for _ in range(2))
                o = flash_attention(q, k, v, window=win, softcap=cap,
                                    lse=lse)
                o_p = tc32_variant(libs["flash32_parent"], q, k, v, win, cap,
                                   lse_p)
                if not (torch.equal(o, o_p) and torch.equal(lse, lse_p)):
                    raise AssertionError(f"{label}: output or lse differs "
                                         f"from the parent build's")
                order = [("shipped", lambda: flash_attention(
                              q, k, v, window=win, softcap=cap)),
                         ("parent", lambda: tc32_variant(
                             libs["flash32_parent"], q, k, v, win, cap))]
                run_in_turns(label, order[::-1], o, calls=5)
                dout = torch.randn((pb, ps, ph, pd), generator=gen,
                                   device=dev).transpose(1, 2)
                label = label.replace("flash_attention", "flash_attention_bwd")
                order = [("shipped", lambda: flash_attention_bwd(
                              q, k, v, o, dout, lse, win, cap)),
                         ("parent", lambda: bwd32_variant(
                             libs["bwd32_parent"], q, k, v, o, dout, lse,
                             win, cap))]
                run_in_turns(label, order[::-1], order[0][1](), calls=5)
                times[f"{label} bit for bit with the parent"] = 1.0
                log(f"{label}: output, lse and gradients bit for bit equal "
                    f"to the parent build's")
                del q, k, v, o, dout, lse, lse_p, o_p, order
                torch.cuda.empty_cache()

    if "flash_parent" in libs:
        # the bf16 routes against an earlier build of their sources, both
        # libraries called the same way; then each kernel's device time
        shipped = {"flash": _build.library("flash"),
                   "bwd_tc": _build.library("bwd_tc")}
        for B, S in ((1, 32768), (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ)):
            q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d,
                                         torch.bfloat16, dev)
            label = f"flash_attention B={B} H={H}/{Hkv} S={S} d={d} bf16"
            order = [(name, lambda lib=lib: bf16_flash(lib, q, k, v))
                     for name, lib in (("shipped", shipped["flash"]),
                                       ("parent", libs["flash_parent"]))]
            run_in_turns(label, order, flash_attention(q, k, v),
                         calls=1 if S > 4096 else 5)
            runs = [order]
            if S == smoke.TRAIN_SEQ:
                dout = torch.randn((B, S, H, d), generator=gen, device=dev,
                                   dtype=torch.bfloat16).transpose(1, 2)
                lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
                o = flash_attention(q, k, v, lse=lse)
                bwd_label = (f"flash_attention_bwd B={B} H={H}/{Hkv} S={S} "
                             f"d={d} bf16")
                bwd_order = [
                    (name, lambda lib=lib: bf16_bwd(lib, q, k, v, o, dout,
                                                    lse))
                    for name, lib in (("shipped", shipped["bwd_tc"]),
                                      ("parent", libs["bwd_tc_parent"]))]
                run_in_turns(bwd_label, bwd_order,
                             flash_attention_bwd(q, k, v, o, dout, lse),
                             calls=3)
                runs.append(bwd_order)
            for run, kernels, lab in zip(
                    runs, (("flash_tc_kernel",),
                           ("rows_tc_kernel", "dkdv_tc_kernel",
                            "dq_tc_kernel")),
                    (label, f"flash_attention_bwd B={B} S={S} bf16")):
                for rnd, seq in enumerate((run, run[::-1])):
                    for name, fn in seq:
                        for kernel in kernels:
                            ms, n = smoke.kernel_device_ms(fn, kernel,
                                                           calls=5)
                            times[f"{lab} {name} {kernel} device "
                                  f"[{rnd}]"] = ms
                            log(f"{lab} {name} {kernel} device [{rnd}]: "
                                f"{ms} ms ({n} launches recorded)")
            del q, k, v, order, runs
            torch.cuda.empty_cache()
    for line in _build.build_log("flash32", "bwd32").splitlines():
        log(f"ptxas: {line.strip()}")
    for name in SECTION_VARIANTS["f32"]:
        for line in BUILD_LOGS.get(name, "").splitlines():
            log(f"ptxas ({name}): {line.strip()}")


def d256_section(smoke, times, run_in_turns, gen, dev, bk16=None) -> None:
    """gemma2-2b's float32 attention at d = 256 (the f32 section): the
    forward at a global layer's prefill (B 1, H 8/4, S 32,768, softcap 50)
    and a local one's (window 4,096), the backward at train_4k's layer (B
    1, S 4,096, softcap 50): the three-piece route beside the SIMT kernel,
    SDPA's float32 call (``chip_smoke._sdpa_f32`` and
    ``_sdpa_f32_backward``, efficient backend, no softcap) and, for the
    forward, ``bk16`` (the f32_bk16 build, called as the wrapper calls the
    shipped one), each route held to its check first, timed in turns, with
    the device time of each kernel of the route."""
    import torch
    from repro_torch.configs.registry import get_spec
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    cfg = get_spec(smoke.GEMMA_ARCH).config
    H, Hkv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.attn_softcap
    for window in (0, cfg.window):
        B, S = 1, smoke.GEMMA_ROW_SEQ
        label = (f"flash_attention gemma2 B={B} H={H}/{Hkv} S={S} d={d} "
                 f"window={window} softcap={cap:g} f32")
        q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.float32,
                                     dev)
        order = [("tc32 route", lambda: flash_attention(
                      q, k, v, window=window, softcap=cap)),
                 ("SIMT route", lambda: smoke.simt_flash(q, k, v, window,
                                                         cap))]
        if bk16 is not None:
            order.insert(1, ("f32_bk16", lambda: bk16(q, k, v, window, cap)))
        want = ref.mha_reference(q, k, v, True, window, cap)
        exact = smoke.f64_reference(q, k, v, window, cap)
        for name, fn in order:
            err, ratio, rule = smoke.f32_err(fn(), want, exact)
            times[f"{label} {name} tolerance ratio"] = ratio
            log(f"{label} {name}: max abs err {err}, {ratio}x ({rule} "
                f"rule)")
            if not ratio <= 1.0:
                raise AssertionError(f"{label} {name}: {ratio}x the check")
        del want, exact
        torch.cuda.empty_cache()
        lib = smoke._sdpa_f32(q, k, v, window=window)
        if lib is not None:
            order.append(("SDPA efficient (no softcap)", lib))
        run_in_turns(label, order, order[0][1](), calls=1,
                     exact=["tc32 route"])
        for kernel in ("flash32_kernel", "split_kernel"):
            ms, n = smoke.kernel_device_ms(order[0][1], kernel, calls=3)
            times[f"{label} {kernel} device"] = ms
            log(f"{label} {kernel} device: {ms} ms ({n} launches recorded)")
        del q, k, v, order, lib
        torch.cuda.empty_cache()

    B, S = 1, smoke.GEMMA_BWD_SEQ
    label = (f"flash_attention_bwd gemma2 B={B} H={H}/{Hkv} S={S} d={d} "
             f"softcap={cap:g} f32")
    q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.float32, dev)
    dout = torch.randn((B, S, H, d), generator=gen,
                       device=dev).transpose(1, 2)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    o = flash_attention(q, k, v, softcap=cap, lse=lse)
    order = [("tc32 route",
              lambda: flash_attention_bwd(q, k, v, o, dout, lse, 0, cap)),
             ("SIMT route",
              lambda: smoke.simt_bwd(q, k, v, o, dout, lse, 0, cap))]
    want = ref.flash_attention_backward_reference(q, k, v, dout, 0, cap)
    bound = smoke.flash_bwd_bound(q, k, v, o, dout, want, 0, cap)
    for name, fn in order:
        err, ratio = smoke.bwd_err(fn(), want, bound)
        times[f"{label} {name} bound ratio"] = ratio
        log(f"{label} {name}: max abs err {err}, {ratio}x flash_bwd_bound")
        if not ratio <= 1.0:
            raise AssertionError(f"{label} {name}: {ratio}x the bound")
    del want, bound
    torch.cuda.empty_cache()
    lib = smoke._sdpa_f32_backward(q, k, v, dout)
    order.append(("SDPA efficient backward (no softcap)", lib))
    run_in_turns(label, order, order[0][1](), calls=3, exact=["tc32 route"])
    for kernel in ("split_kernel", "rows_kernel", "dkdv_kernel", "dq_kernel"):
        ms, n = smoke.kernel_device_ms(order[0][1], kernel, calls=5)
        times[f"{label} {kernel} device"] = ms
        log(f"{label} {kernel} device: {ms} ms ({n} launches recorded)")
    del q, k, v, o, dout, lse, order, lib
    torch.cuda.empty_cache()


def small_d_rows(smoke, times, run_in_turns, gen, dev, variants) -> None:
    """float32 attention at d = 16 and 32, which no zoo config uses (the f32
    section): the forward at B 1, H 16/8, S 32,768 and the backward at B
    8, H 16/8, S 2,048 (qwen3-0.6b's heads and shapes), the three-piece
    route beside the SIMT kernel it replaced (``chip_smoke.simt_flash`` and
    ``simt_bwd``), SDPA's float32 call and, for the forward, the builds of
    ``variants`` (name: the call, as the wrapper calls the shipped
    library), each held to its check first but the timing-only
    ``F32_PHASES``, timed in turns, with each kernel's device time, the
    plain version's time, the split floor, the float32 CUDA-core bound
    and, for the forward, the exponentials' floor: one ex2 a visible score
    at 16 a clock an SM on 132 SMs at the card's largest SM clock."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (attention_ops,
                                                     causal_pairs,
                                                     flash_attention,
                                                     flash_attention_bwd)
    sfu_per_s = 16 * 132 * smoke.sm_clock_hz()
    for d in (16, 32):
        B, H, Hkv, S = 1, 16, 8, 32768
        label = f"flash_attention B={B} H={H}/{Hkv} S={S} d={d} f32"
        q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.float32,
                                     dev)
        order = [("tc32 route", lambda: flash_attention(q, k, v)),
                 *[(name, lambda fn=fn: fn(q, k, v))
                   for name, fn in variants.items()
                   if name not in F32_PHASES],
                 ("SIMT route", lambda: smoke.simt_flash(q, k, v))]
        want = ref.mha_reference(q, k, v)
        exact = smoke.f64_reference(q, k, v)
        for name, fn in order:
            err, ratio, rule = smoke.f32_err(fn(), want, exact)
            times[f"{label} {name} tolerance ratio"] = ratio
            log(f"{label} {name}: max abs err {err}, {ratio}x ({rule} "
                f"rule)")
            if not ratio <= 1.0:
                raise AssertionError(f"{label} {name}: {ratio}x the check")
        del want, exact
        torch.cuda.empty_cache()
        ops = attention_ops(B, H, S, d)
        row = {"plain_ms": smoke.time_ms(lambda: ref.mha_reference(q, k, v),
                                         calls=1, reps=1),
               "bound_ms": ops / smoke.SPLIT_OPS_PER_S * 1e3,
               "exp_floor_ms": B * H * causal_pairs(S) / sfu_per_s * 1e3,
               "cuda_core_bound_ms": ops / smoke.SCALAR_OPS_PER_S * 1e3}
        lib = smoke._sdpa_f32(q, k, v)
        if lib is not None:
            order.append(("SDPA efficient", lib))
        run_in_turns(label, order, order[0][1](), calls=1,
                     exact=["tc32 route"])
        for kernel in ("flash32_kernel", "split_kernel"):
            row[f"{kernel} device_ms"] = smoke.kernel_device_ms(
                order[0][1], kernel, calls=3)[0]
        # timing only, outputs wrong by design: one phase cut each
        phases = [order[0]] + [(name, lambda fn=fn: fn(q, k, v))
                               for name, fn in variants.items()
                               if name in F32_PHASES]
        if len(phases) > 1:
            run_in_turns(f"{label} phases", phases, None, calls=1, exact=[])
            for name, fn in phases:
                row[f"{name} flash32_kernel device_ms"] = \
                    smoke.kernel_device_ms(fn, "flash32_kernel", calls=3)[0]
        for key, val in row.items():
            times[f"{label} {key}"] = val
        log(f"{label}: {json.dumps(row)}")
        del q, k, v, order, phases, lib
        torch.cuda.empty_cache()

        B, S = smoke.TRAIN_BATCH, smoke.TRAIN_SEQ
        label = f"flash_attention_bwd B={B} H={H}/{Hkv} S={S} d={d} f32"
        q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.float32,
                                     dev)
        dout = torch.randn((B, S, H, d), generator=gen,
                           device=dev).transpose(1, 2)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        o = flash_attention(q, k, v, lse=lse)
        order = [("tc32 route",
                  lambda: flash_attention_bwd(q, k, v, o, dout, lse)),
                 ("SIMT route",
                  lambda: smoke.simt_bwd(q, k, v, o, dout, lse))]
        want = ref.flash_attention_backward_reference(q, k, v, dout)
        bound = smoke.flash_bwd_bound(q, k, v, o, dout, want)
        for name, fn in order:
            err, ratio = smoke.bwd_err(fn(), want, bound)
            times[f"{label} {name} bound ratio"] = ratio
            log(f"{label} {name}: max abs err {err}, {ratio}x "
                f"flash_bwd_bound")
            if not ratio <= 1.0:
                raise AssertionError(f"{label} {name}: {ratio}x the bound")
        del want, bound
        torch.cuda.empty_cache()
        ops = 2.5 * attention_ops(B, H, S, d)
        row = {"plain_ms": smoke.time_ms(
                   lambda: ref.flash_attention_backward_reference(
                       q, k, v, dout), calls=1, reps=1),
               "bound_ms": ops / smoke.SPLIT_OPS_PER_S * 1e3,
               "cuda_core_bound_ms": ops / smoke.SCALAR_OPS_PER_S * 1e3}
        order.append(("SDPA efficient backward",
                      smoke._sdpa_f32_backward(q, k, v, dout)))
        run_in_turns(label, order, order[0][1](), calls=3,
                     exact=["tc32 route"])
        for kernel in ("split_kernel", "rows_kernel", "dkdv_kernel",
                       "dq_kernel"):
            row[f"{kernel} device_ms"] = smoke.kernel_device_ms(
                order[0][1], kernel, calls=5)[0]
        for key, val in row.items():
            times[f"{label} {key}"] = val
        log(f"{label}: {json.dumps(row)}")
        del q, k, v, o, dout, lse, order
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
