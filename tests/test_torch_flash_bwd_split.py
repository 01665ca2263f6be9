"""The arithmetic of the bf16 tensor-core ``flash_attention_bwd`` kernels
(``csrc/flash_bwd_tc.cu``), emulated in plain torch on the CPU, against
the plain version and ``jax.grad`` of the JAX package's plain attention.

The kernels cannot run here, so their arithmetic is emulated as they run:
dK and dV by BN-key tiles, each summing the G query heads of its group in
order and, of each, the 64-row query tiles that see it; dQ by BN-row
query tiles over 64-key tiles from the window's first to the diagonal (BN
= 128, and 64 at d = 256, where a block's two warpgroups share its tile
and split the gradients' columns: the kernels' ``Plan``).
S^T and dP^T (S and dP) are float32 products of the bf16 inputs (at d =
256 the sum of the two warpgroups' products over their halves of d); P =
2^(s log2 e - lse2) from the forward's row lse (lse2 = lse log2 e); dS =
P (dP - Delta) f with Delta = rowsum(dO O) from the forward's bf16 output
and f the softcap's factor; P and dS enter their products split into
hi = bf16(x) and lo = bf16(x - hi), summed tile by tile in float32; dq,
dk and dv rounded once. Held to the card's check of the kernels
(``chip_smoke.flash_bwd_bound``) at <= 0.7 against the plain version and
against ``jax.grad`` (its gradients rounded once to bf16); on a
constructed cancellation case the same emulation with P and dS rounded
once fails that check on each of dq, dk and dv."""

import heapq
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
    # d = 256: GQA groups 1, 2 and 4, softcap 50, windows, S off the
    # 64-row tile
    (1, 2, 2, 67, 256, 0, 50.0),
    (1, 4, 2, 130, 256, 33, 0.0),
    (1, 8, 2, 100, 256, 0, 50.0),
    (1, 4, 1, 65, 256, 1, 0.0),
]
CANCEL_CASE = (1, 4, 2, 256, 128, 0, 0.0)


def plan(d: int) -> tuple[int, int, int]:
    """The kernels' ``Plan<d>``: (BN, BT, parts), the rows of a block's
    fixed tile and of a ring tile, and the parts of d whose products are
    summed for S and dP (2 with ``EXCHANGE``, at d = 256)."""
    return (64, 64, 2) if d == 256 else (128, 64, 1)


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
    BN, BT, d_parts = plan(d)
    scale = d ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))

    def product(eq, x, y):
        """S or dP: float32 products over each part of d, summed."""
        w = d // d_parts
        out = torch.einsum(eq, x[..., :w], y[..., :w])
        for i in range(1, d_parts):
            out += torch.einsum(eq, x[..., i * w:(i + 1) * w],
                                y[..., i * w:(i + 1) * w])
        return out
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
                s = product("bhkd,bhqd->bhkq", kt, qt)      # S^T
                dp = product("bhkd,bhqd->bhkq", vt, dot)    # dP^T
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
            s = product("bhqd,bhkd->bhqk", qf[:, :, q0:q0 + BN], kt)
            dp = product("bhqd,bhkd->bhqk", dof[:, :, q0:q0 + BN], vt)
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
    """bf16 cases (d 16 to 256, GQA groups 1, 2 and 4, windows, softcaps,
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
    """bf16 takes the tensor cores at every head dim, d = 256 included;
    float32 takes the three-piece tensor-core route at every head dim too
    (one-pass TF32 would break its bound; the SIMT kernel is on no
    route)."""
    assert d in TC_BWD_HEAD_DIMS
    assert bwd_route(torch.bfloat16, d) == "tc"
    assert bwd_route(torch.float32, d) == "tc32"


def _makespan(work, sms=132):
    """The time the last of ``work``'s blocks ends when each, in launch
    order, goes to the first SM that is free (one block an SM, as the
    kernels' shared memory and registers allow)."""
    ends = [0] * sms
    heapq.heapify(ends)
    for w in work:
        heapq.heappush(ends, heapq.heappop(ends) + w)
    return max(ends)


@pytest.mark.parametrize("B,H,Hkv,S,d,head_major,tile_major", [
    (1, 8, 4, 4096, 256, (190, 156), (128, 127)),     # gemma2, train_4k
    (8, 16, 8, 2048, 128, (304, 282), (268, 264)),    # qwen3, train
])
def test_tile_major_grid_order_balances_the_blocks(B, H, Hkv, S, d,
                                                    head_major, tile_major):
    """A model of the kernels' grids on 132 SMs, in (key or query tile,
    64-row ring tiles) units of work: each block's work by the kernels'
    loop bounds (dkdv: the G heads' query tiles from its keys to S; dq:
    its key tiles up to the diagonal), blocks in linear launch order. The
    tile-major order (``Plan::TILE_MAJOR``, d = 256) ends within 2% of
    the mean; d <= 128's (tiles, heads, B) order ends far later at d =
    256 (190 against 126: the first (head, batch) pairs' short tiles
    take SMs that the last pairs' long tiles wait for)."""
    BN, BT, _ = plan(d)
    G, tiles = H // Hkv, -(-S // BN)
    dkdv = [G * (S // BT - t * BN // BT) for t in range(tiles)]
    dq = [(tiles - 1 - t) * BN // BT + BN // BT for t in range(tiles)]
    got_head = tuple(_makespan([w for _ in range(n) for w in work])
                     for work, n in ((dkdv, B * Hkv), (dq, B * H)))
    got_tile = tuple(_makespan([w for w in work for _ in range(n)])
                     for work, n in ((dkdv, B * Hkv), (dq, B * H)))
    means = (sum(dkdv) * B * Hkv / 132, sum(dq) * B * H / 132)
    print(f"head-major {got_head}, tile-major {got_tile}, mean {means}")
    assert got_head == head_major and got_tile == tile_major
    assert all(t <= 1.02 * m for t, m in zip(got_tile, means))

