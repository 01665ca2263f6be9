"""The arithmetic of the bf16 ``decode_attention`` kernel
(``csrc/decode_tc.cu``), emulated in plain torch on the CPU, against the
plain version and the JAX package's Pallas kernel (interpret mode).

The kernel cannot run here, so its arithmetic is emulated as it runs:
the chunks of ``split_plan``, tiles of ``TILE[d]`` keys starting at each
chunk's first visible key, four warps taking a quarter of every tile with
an online softmax of their own (float32 scores of bf16 inputs, log2
units), the warps merged at the chunk's end, and the chunks merged by
their (max, sum). Held to ``chip_smoke.py``'s decode check (ATTN_TOL per
element: the bf16 output's own rounding, no term for P, which stays
float32) and to ``tests/test_kernels.py``'s tolerance of the Pallas
kernel."""

import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.decode_attention import \
    decode_attention as pallas_decode  # noqa: E402
from test_kernels import tol  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import (SMS, TILE,  # noqa: E402
                                                  decode_attention,
                                                  split_plan)

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.4426950408889634
WARPS = 4                    # consumer warps of the kernel
S_TEST = 320                 # a multiple of the Pallas kernel's 64-key block
# B, H, Hkv, d, window, softcap: GQA groups of 1, 2, 8 and 16; windows of
# 100 and 300 from length 320 start inside a chunk (256 keys; 128 at
# d = 256) and windows end inside a tile at the ragged lengths
CASES = [
    (8, 2, 2, 64, 0, 0.0), (8, 4, 2, 128, 100, 0.0),
    (8, 4, 2, 128, 0, 50.0), (8, 8, 4, 256, 100, 50.0),
    (8, 8, 1, 32, 300, 30.0), (8, 16, 2, 16, 0, 0.0),
    (8, 16, 1, 128, 100, 0.0), (8, 16, 1, 256, 0, 30.0),
]


def _smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def emulate(q, k, v, lengths, window=0, softcap=0.0):
    """The kernel's arithmetic on q [B, H, d], caches [B, Hkv, S, d]
    (bf16) and lengths [B] -> [B, H, d] bf16."""
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    chunk, n_split = split_plan(B, Hkv, S, d)
    tile = TILE[d]
    kw = tile // WARPS
    scale = d ** -0.5
    out = torch.zeros((B, H, d))
    for b in range(B):
        n = max(0, min(int(lengths[b]), S))
        lo = max(0, n - window) if window > 0 else 0
        for kh in range(Hkv):
            qg = q[b, kh * G:(kh + 1) * G].float()                # [G, d]
            parts = []
            for split in range(n_split):
                c0, c1 = max(lo, split * chunk), min(n, (split + 1) * chunk)
                if c0 >= c1:
                    continue          # the block exits before any load
                m = torch.full((WARPS, G), -math.inf)
                l = torch.zeros((WARPS, G))
                acc = torch.zeros((WARPS, G, d))
                for row0 in range(c0, c1, tile):
                    keys = torch.arange(row0, row0 + tile).view(WARPS, kw)
                    rows = keys.clamp(max=S - 1)
                    past = keys >= S                   # TMA fills zeros
                    kt = k[b, kh][rows].float().masked_fill(past[..., None],
                                                            0.0)
                    vt = v[b, kh][rows].float().masked_fill(past[..., None],
                                                            0.0)
                    s = torch.einsum("gd,wkd->wgk", qg, kt)
                    if softcap > 0:
                        x = torch.tanh(s * (scale / softcap)) * (softcap
                                                                 * LOG2E)
                    else:
                        x = s * (scale * LOG2E)
                    valid = (keys < c1)[:, None, :]
                    x = x.masked_fill(~valid, -math.inf)
                    m_new = torch.maximum(m, x.amax(dim=-1))
                    m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                    alpha = torch.exp2(m - m_use)
                    p = torch.exp2(x - m_use[..., None])
                    l = l * alpha + p.sum(dim=-1)
                    m = m_new
                    # rows past the chunk's end are skipped, not weighted 0
                    pv = torch.einsum("wgk,wkd->wgd", p,
                                      vt.masked_fill(~valid[:, 0, :, None],
                                                     0.0))
                    acc = acc * alpha[..., None] + pv
                mx = m.amax(dim=0)
                f = torch.exp2(m - torch.where(mx == -math.inf, 0.0, mx))
                parts.append((mx, (f * l).sum(dim=0),
                              (f[..., None] * acc).sum(dim=0)))
            if not parts:
                continue              # length 0: zeros
            mx = torch.stack([p[0] for p in parts])
            f = torch.exp2(mx - mx.amax(dim=0))
            total = (f * torch.stack([p[1] for p in parts])).sum(dim=0)
            o = (f[..., None] * torch.stack([p[2] for p in parts])).sum(dim=0)
            out[b, kh * G:(kh + 1) * G] = o / total.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


def _inputs(B, H, Hkv, S, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 [(B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)])


@pytest.mark.parametrize("case", CASES)
def test_emulation_within_the_decode_check(case):
    """Ragged lengths at the tile and chunk edges and 0 in one batch: the
    emulation within ATTN_TOL of the plain version, and within
    ``tests/test_kernels.py``'s tolerance of the Pallas kernel."""
    smoke = _smoke()
    B, H, Hkv, d, win, cap = case
    qn, kn, vn = _inputs(B, H, Hkv, S_TEST, d, H + d + win)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    lens = smoke.decode_edge_lengths(B, Hkv, S_TEST, d)
    lengths = torch.tensor(lens, dtype=torch.int32)
    got = emulate(q, k, v, lengths, win, cap)
    want = ref.decode_reference(q, k, v, lengths, win, cap)
    err, ratio = smoke.attn_err(got, want)
    print(f"{case} lengths {lens}: {err} ({ratio}x the check)")
    assert ratio <= 1.0
    assert not got[lens.index(0)].any()
    assert torch.equal(decode_attention(q, k, v, lengths, win, cap), want)
    pallas = pallas_decode(*(jnp.asarray(a, jnp.bfloat16)
                             for a in (qn, kn, vn)),
                           jnp.asarray(np.asarray(lens, np.int32)),
                           window=win, softcap=cap, bk=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               **tol(jnp.bfloat16))


def test_emulation_fails_the_check_when_a_tile_is_lost():
    """The check sees a kernel that loses one tile of keys: the emulation
    with the chunk's last tile left out is far outside ATTN_TOL."""
    smoke = _smoke()
    B, H, Hkv, d = 8, 4, 2, 128
    qn, kn, vn = _inputs(B, H, Hkv, S_TEST, d, 3)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    lengths = torch.full((B,), S_TEST, dtype=torch.int32)
    want = ref.decode_reference(q, k, v, lengths)
    assert smoke.attn_err(emulate(q, k, v, lengths), want)[1] <= 1.0
    short = lengths - TILE[d]
    assert smoke.attn_err(emulate(q, k, v, short), want)[1] > 1.0


@pytest.mark.parametrize("d", sorted(TILE))
@pytest.mark.parametrize("B,Hkv,S", [(8, 8, 32768), (1, 1, 1), (3, 2, 1000),
                                     (8, 4, 32768), (128, 8, 32768),
                                     (2, 1, 64), (1, 16, 100_000)])
def test_split_plan_covers_every_key_once(B, Hkv, S, d):
    """Chunks of whole tiles, at least four, that tile [0, S) exactly:
    every key lies in exactly one chunk, and no chunk starts past S."""
    chunk, n_split = split_plan(B, Hkv, S, d)
    assert chunk % TILE[d] == 0 and chunk >= 4 * TILE[d]
    assert (n_split - 1) * chunk < S <= n_split * chunk
    owner = np.arange(S) // chunk
    assert np.array_equal(np.bincount(owner, minlength=n_split),
                          [min(chunk, S - i * chunk) for i in range(n_split)])


@pytest.mark.parametrize("d,min_blocks", [(128, 4 * SMS), (256, 4 * SMS)])
def test_split_plan_fills_the_card_at_serving_shapes(d, min_blocks):
    """qwen3-0.6b's decode (B = 8, Hkv = 8, 32,768 positions) and gemma2's
    (Hkv = 4, d = 256): the grid is at least one wave of 132 SMs, here
    about four waves of two blocks an SM."""
    B, Hkv = (8, 8) if d == 128 else (8, 4)
    chunk, n_split = split_plan(B, Hkv, 32768, d)
    assert B * Hkv * n_split >= SMS
    assert B * Hkv * n_split >= min_blocks
