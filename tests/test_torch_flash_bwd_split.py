"""The arithmetic of the bf16 tensor-core ``flash_attention_bwd`` kernels
(``csrc/flash_bwd_tc.cu``), emulated in plain torch on the CPU, against
the plain version and ``jax.grad`` of the JAX package's plain attention.

The kernels cannot run here, so their arithmetic is emulated as they run:
dK and dV by 128-key tiles, each summing the G query heads of its group in
order and, of each, the 64-row query tiles that see it; dQ by 128-row
query tiles over 64-key tiles from the window's first to the diagonal.
S^T and dP^T (S and dP) are float32 products of the bf16 inputs; P =
2^(s log2 e - lse2) from the forward's row lse (lse2 = lse log2 e); dS =
P (dP - Delta) f with Delta = rowsum(dO O) from the forward's bf16 output
and f the softcap's factor; P and dS enter their products split into
hi = bf16(x) and lo = bf16(x - hi), summed tile by tile in float32; dq,
dk and dv rounded once. Held to the card's check of the kernels
(``chip_smoke.flash_bwd_bound``) at <= 0.7 against the plain version and
against ``jax.grad`` (its gradients rounded once to bf16); on a
constructed cancellation case the same emulation with P and dS rounded
once fails that check on each of dq, dk and dv."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, TC_BWD_HEAD_DIMS, bwd_route, flash_attention)

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.4426950408889634
BF16 = torch.bfloat16
BN, BT = 128, 64        # the kernels' Plan: block rows, ring-tile rows
SPLIT_LIMIT = 0.7       # of flash_bwd_bound, on every bf16 case
CASES = [  # B, H, Hkv, S, d, window, softcap
    (1, 2, 2, 67, 64, 0, 0.0),
    (2, 4, 2, 130, 64, 48, 0.0),
    (1, 8, 2, 200, 128, 0, 30.0),
    (1, 4, 4, 257, 128, 100, 20.0),
    (1, 8, 4, 190, 128, 0, 0.0),
    (1, 8, 2, 300, 64, 64, 0.0),
    (1, 4, 2, 1, 128, 0, 0.0),
    (1, 4, 2, 97, 32, 1, 0.0),
    (1, 4, 2, 130, 16, 0, 0.0),
]
CANCEL_CASE = (1, 4, 2, 256, 128, 0, 0.0)


def _smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def emulate(q, k, v, o, dout, lse, window=0, softcap=0.0, split=True):
    """The kernels' arithmetic on bf16 [B, H, S, d] inputs, the forward's
    bf16 output ``o`` and float32 row ``lse`` -> bf16 (dq, dk, dv).

    ``split=False`` rounds P and dS once to bf16 instead."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = d ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    lse2 = lse.float() * LOG2E
    delta = (dof * o.float()).sum(-1)

    def parts(x):
        hi = x.to(BF16).float()
        return hi, (x - hi).to(BF16).float() if split else 0.0 * hi

    def p_ds(s, dp, l2, dl, live):
        if softcap > 0:
            t = torch.tanh(s * (scale / softcap))
            p, f = torch.exp2(t * (softcap * LOG2E) - l2), 1 - t * t
        else:
            p, f = torch.exp2(s * (scale * LOG2E) - l2), 1.0
        p = torch.where(live, p, 0.0)
        return p, p * (dp - dl) * f

    def live(keys, rows):
        ok = keys[:, None] <= rows[None, :]
        if window > 0:
            ok &= keys[:, None] > rows[None, :] - window
        return ok

    dk = torch.zeros((B, Hkv, S, d))
    dv = torch.zeros((B, Hkv, S, d))
    for k0 in range(0, S, BN):
        keys = torch.arange(k0, min(S, k0 + BN))
        kt, vt = kf[:, :, k0:k0 + BN], vf[:, :, k0:k0 + BN]
        last_row = min(S - 1, int(keys[-1]) + window - 1) if window else S - 1
        for g in range(G):      # heads kh G + g of every kv head kh
            for q0 in range(k0, last_row + 1, BT):
                rows = torch.arange(q0, min(S, q0 + BT))
                qt, dot = qf[:, g::G, q0:q0 + BT], dof[:, g::G, q0:q0 + BT]
                s = torch.einsum("bhkd,bhqd->bhkq", kt, qt)      # S^T
                dp = torch.einsum("bhkd,bhqd->bhkq", vt, dot)    # dP^T
                p, ds = p_ds(s, dp, lse2[:, g::G, None, q0:q0 + BT],
                             delta[:, g::G, None, q0:q0 + BT],
                             live(keys, rows))
                for x, y, acc in ((p, dot, dv), (ds, qt, dk)):
                    for part in parts(x):
                        acc[:, :, k0:k0 + BN] += torch.einsum(
                            "bhkq,bhqd->bhkd", part, y)
    kr, vr = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    dq = torch.zeros((B, H, S, d))
    for q0 in range(0, S, BN):
        rows = torch.arange(q0, min(S, q0 + BN))
        first = max(0, q0 - window + 1) // BT * BT if window else 0
        for k0 in range(first, int(rows[-1]) + 1, BT):
            keys = torch.arange(k0, min(S, k0 + BT))
            kt, vt = kr[:, :, k0:k0 + BT], vr[:, :, k0:k0 + BT]
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, q0:q0 + BN], kt)
            dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, q0:q0 + BN], vt)
            _, ds = p_ds(s, dp, lse2[:, :, q0:q0 + BN, None],
                         delta[:, :, q0:q0 + BN, None], live(keys, rows).T)
            for part in parts(ds):
                dq[:, :, q0:q0 + BN] += torch.einsum("bhqk,bhkd->bhqd", part,
                                                     kt)
    return (dq * scale).to(BF16), (dk * scale).to(BF16), dv.to(BF16)


def _inputs(case, seed, paired=False):
    """q, k, v, dout as float32 numpy arrays of bf16 values. ``paired``:
    rows in pairs, q and k rows 2i + 1 equal to rows 2i, v and dout rows
    2i + 1 their negatives, so each of dq, dk and dv cancels to near 0."""
    B, H, Hkv, S, d, _, cap = case
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, H, S, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Hkv, S, d)).astype(np.float32)
            for _ in range(2))
    if cap > 0:     # scores ~ N(0, (c/2)^2): the cap bites
        q *= cap / 2
    if paired:
        q[:, :, 1::2], k[:, :, 1::2] = q[:, :, 0::2], k[:, :, 0::2]
        v[:, :, 1::2], do[:, :, 1::2] = -v[:, :, 0::2], -do[:, :, 0::2]
    return [torch.from_numpy(x).to(BF16).float().numpy()
            for x in (q, k, v, do)]


def _forward(q, k, v, case):
    """The forward's bf16 output and float32 row lse (its CPU route)."""
    B, H, _, S, _, win, cap = case
    lse = torch.empty((B, H, S))
    return flash_attention(q, k, v, window=win, softcap=cap, lse=lse), lse


def _ratios(smoke, got, want, bound):
    return [smoke.bwd_err((g,), (w,), (b,))[1]
            for g, w, b in zip(got, want, bound)]


@pytest.mark.parametrize("case", CASES)
def test_split_emulation_within_the_bound_of_plain_and_jax(case):
    """bf16 cases (d 16 to 128, GQA groups 1, 2 and 4, windows, softcaps,
    ragged S, S = 1): the emulation within SPLIT_LIMIT of
    ``flash_bwd_bound`` around the plain version, and around ``jax.grad``
    of ``repro.kernels.ref.mha_reference`` on the same float32 values
    (each gradient rounded once to bf16)."""
    smoke = _smoke()
    B, H, Hkv, S, d, win, cap = case
    qn, kn, vn, don = _inputs(case, S + d + H)
    q, k, v, do = (torch.from_numpy(x).to(BF16) for x in (qn, kn, vn, don))
    o, lse = _forward(q, k, v, case)
    got = emulate(q, k, v, o, do, lse, win, cap)
    want = ref.flash_attention_backward_reference(q, k, v, do, win, cap)
    bound = smoke.flash_bwd_bound(q, k, v, o, do, want, win, cap)
    plain = _ratios(smoke, got, want, bound)

    def f(q_, k_, v_):
        return jnp.sum(jref.mha_reference(q_, k_, v_, True, win, cap) * don)
    jgrads = [torch.from_numpy(np.array(g)).to(BF16) for g in jax.jit(
        jax.grad(f, argnums=(0, 1, 2)))(jnp.asarray(qn), jnp.asarray(kn),
                                        jnp.asarray(vn))]
    jbound = smoke.flash_bwd_bound(q, k, v, o, do, jgrads, win, cap)
    vs_jax = _ratios(smoke, got, jgrads, jbound)
    print(f"{case}: {plain} of the bound (plain), {vs_jax} (jax.grad)")
    assert max(plain) <= SPLIT_LIMIT
    assert max(vs_jax) <= SPLIT_LIMIT


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_passes_and_single_rounding_fails_cancellation(seed):
    """Rows in pairs that cancel (``_inputs(paired=True)``): every
    gradient near 0, where one rounding of P (dv) or dS (dq, dk) leaves up
    to 2^-9 of each term against the bound's 2^-14 of their sum. The
    split stays within SPLIT_LIMIT on each; P and dS rounded once fail
    the check on each of dq, dk and dv."""
    smoke = _smoke()
    case = CANCEL_CASE
    _, _, _, _, _, win, cap = case
    q, k, v, do = (torch.from_numpy(x).to(BF16)
                   for x in _inputs(case, seed, paired=True))
    o, lse = _forward(q, k, v, case)
    want = ref.flash_attention_backward_reference(q, k, v, do, win, cap)
    bound = smoke.flash_bwd_bound(q, k, v, o, do, want, win, cap)
    split = _ratios(smoke, emulate(q, k, v, o, do, lse, win, cap), want,
                    bound)
    once = _ratios(smoke, emulate(q, k, v, o, do, lse, win, cap,
                                  split=False), want, bound)
    print(f"seed {seed}: split {split}, rounded once {once} (dq, dk, dv) "
          f"of the bound")
    assert max(split) <= SPLIT_LIMIT
    assert min(once) > 1.0


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_backward_route_by_dtype_and_head_dim(d):
    """bf16 takes the tensor cores at d = 16 to 128 and the SIMT kernel at
    d = 256; float32 always takes the SIMT kernel (TF32 would break its
    bound)."""
    assert bwd_route(torch.bfloat16, d) == (
        "tc" if d in TC_BWD_HEAD_DIMS else "simt")
    assert bwd_route(torch.float32, d) == "simt"
    assert (bwd_route(torch.bfloat16, d) == "tc") == (d <= 128)
