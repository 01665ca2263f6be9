"""The arithmetic of the bf16 tensor-core ``flash_attention`` kernel
(``csrc/flash_tc.cu``), emulated in plain torch on the CPU, against the
plain version and the JAX package's Pallas kernel (interpret mode).

The kernel cannot run here, so its arithmetic is emulated as it runs:
key tiles of 128 (64 at d = 256), float32 scores, an online softmax in
log2 units with the sum l over the unrounded float32 p, and P V taken
with P split into p_hi = bf16(p) and p_lo = bf16(p - p_hi). Held to the
bf16 flash route's check of ``chip_smoke.py`` (ATTN_TOL plus
SPLIT_GROWTH * A, A = sum p|v| / l); the same emulation with P rounded
once must fail that check on the cancellation case."""

import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from test_kernels import FLASH_CASES, tol  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.4426950408889634
CANCEL_CASE = (1, 4, 2, 256, 128, 0, 0.0)   # B, H, Hkv, S, d, window, cap


def _smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def emulate(q, k, v, window=0, softcap=0.0, split=True):
    """The kernel's arithmetic on [B, H, S, d] bf16 inputs -> bf16.

    ``split=False`` rounds P once to bf16 instead (FA2, FA3, SDPA)."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    bk = 128 if d <= 128 else 64
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    scale = d ** -0.5
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, d))
    for k0 in range(0, S, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk])
        if softcap > 0:
            x = torch.tanh(s * (scale / softcap)) * (softcap * LOG2E)
        else:
            x = s * (scale * LOG2E)
        keys = torch.arange(k0, min(S, k0 + bk))[None, :]
        dead = keys > rows
        if window > 0:
            dead |= keys <= rows - window
        x = x.masked_fill(dead, -math.inf)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float() if split else 0.0 * hi
        vt = vf[:, :, k0:k0 + bk]
        o = o * alpha + (torch.einsum("bhqk,bhkd->bhqd", hi, vt)
                         + torch.einsum("bhqk,bhkd->bhqd", lo, vt))
    return (o / l.clamp(min=1e-30)).to(q.dtype)


def _inputs(case, seed, paired=False):
    B, H, Hkv, S, d, _, _ = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               [(B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d)])
    if paired:                     # row 2i + 1 = -row 2i: outputs near 0
        v[:, :, 1::2] = -v[:, :, 0::2]
    return q, k, v


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _check(smoke, case, q, k, v, got):
    """chip_smoke's bf16 flash check of ``got``, and the largest share
    the SPLIT_GROWTH * A term takes of any element's bound."""
    _, _, _, _, _, win, cap = case
    want = ref.mha_reference(q, k, v, True, win, cap)
    A = smoke.split_bound(q, k, v, win, cap)
    atol, rtol = smoke.ATTN_TOL["bfloat16"]
    term = smoke.SPLIT_GROWTH * A.float().abs()
    share = float((term / (atol + rtol * want.float().abs() + term)).max())
    return smoke.attn_err(got, want, A)[1], share


@pytest.mark.parametrize("case", FLASH_CASES)
def test_split_emulation_within_the_bf16_flash_check(case):
    """Over ``FLASH_CASES`` in bf16: the emulation within ATTN_TOL plus
    SPLIT_GROWTH * A of the plain version, and within
    ``tests/test_kernels.py``'s tolerance of the Pallas kernel."""
    smoke = _smoke()
    B, H, Hkv, S, d, win, cap = case
    qn, kn, vn = _inputs(case, S + d + H)
    q, k, v = _bf16(qn), _bf16(kn), _bf16(vn)
    got = emulate(q, k, v, win, cap)
    ratio, share = _check(smoke, case, q, k, v, got)
    print(f"{case}: {ratio}x the check; A term at most {share} of a bound")
    assert ratio <= 1.0
    want = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn)),
                        window=win, softcap=cap, bq=64, bk=64,
                        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **tol(jnp.bfloat16))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_passes_and_single_rounding_fails_cancellation(seed):
    """V rows in pairs of opposite sign: outputs near 0, where one
    rounding of P leaves up to 2^-8 A. The split stays within the check;
    P rounded once, in the kernel's tiles or densely as chip_smoke's
    control computes it, does not."""
    smoke = _smoke()
    qn, kn, vn = _inputs(CANCEL_CASE, seed, paired=True)
    q, k, v = _bf16(qn), _bf16(kn), _bf16(vn)
    split, share = _check(smoke, CANCEL_CASE, q, k, v, emulate(q, k, v))
    once, _ = _check(smoke, CANCEL_CASE, q, k, v,
                     emulate(q, k, v, split=False))
    dense, _ = _check(smoke, CANCEL_CASE, q, k, v,
                      smoke.p_rounded_once(q, k, v))
    print(f"seed {seed}: split {split}x, rounded once {once}x (dense "
          f"control {dense}x) the check; A term at most {share} of a bound")
    assert split <= 1.0
    assert once > 1.0 and dense > 1.0
