"""The port's attention kernels' plain versions against the JAX package's
Pallas kernels (interpret mode) on the same inputs, made with numpy.

On the CPU the port's wrappers run their plain versions, so each case
checks both ``repro_torch.kernels.ref`` and the wrapper's CPU route. The
shapes and tolerances are those of ``tests/test_kernels.py``. The CUDA
kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from test_kernels import DECODE_CASES, FLASH_CASES, tol  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _both(rng, shape, dtypes):
    """The same values as a JAX array and a torch tensor of one dtype
    (both round float32 to bfloat16 to nearest even)."""
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, dtypes[0]), torch.from_numpy(a).to(dtypes[1])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol(dtype))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
def test_flash_plain_matches_pallas(case, dtypes):
    B, H, Hkv, S, d, win, cap = case
    rng = np.random.default_rng(S + d + H)
    (jq, q), (jk, k), (jv, v) = (_both(rng, s, dtypes) for s in
                                 [(B, H, S, d), (B, Hkv, S, d),
                                  (B, Hkv, S, d)])
    want = pallas_flash(jq, jk, jv, window=win, softcap=cap, bq=64, bk=64,
                        interpret=True)
    _close(ref.mha_reference(q, k, v, window=win, softcap=cap), want,
           dtypes[0])
    _close(flash_attention(q, k, v, window=win, softcap=cap), want,
           dtypes[0])


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
def test_decode_plain_matches_pallas(case, dtypes):
    B, H, Hkv, S, d, win = case
    rng = np.random.default_rng(S + d + H)
    (jq, q), (jk, k), (jv, v) = (_both(rng, s, dtypes) for s in
                                 [(B, H, d), (B, Hkv, S, d), (B, Hkv, S, d)])
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    want = pallas_decode(jq, jk, jv, jnp.asarray(lengths), window=win,
                         bk=64, interpret=True)
    tl = torch.from_numpy(lengths)
    _close(ref.decode_reference(q, k, v, tl, window=win), want, dtypes[0])
    _close(decode_attention(q, k, v, tl, window=win), want, dtypes[0])


def test_decode_length_zero_gives_zeros_like_pallas():
    """A sequence with no valid key: zeros, as the Pallas kernel's 1e-30
    denominator gives (the dense JAX reference would average V)."""
    rng = np.random.default_rng(5)
    dt = DTYPES[0]
    (jq, q), (jk, k), (jv, v) = (_both(rng, s, dt) for s in
                                 [(2, 4, 32), (2, 2, 128, 32),
                                  (2, 2, 128, 32)])
    lengths = np.asarray([0, 77], np.int32)
    want = pallas_decode(jq, jk, jv, jnp.asarray(lengths), softcap=30.0,
                         bk=64, interpret=True)
    got = decode_attention(q, k, v, torch.from_numpy(lengths), softcap=30.0)
    assert not got[0].any()
    _close(got, want, dt[0])


@pytest.mark.parametrize("S,window,cap", [(1, 0, 0.0), (37, 0, 50.0),
                                          (37, 8, 0.0), (100, 33, 20.0)])
def test_flash_plain_matches_jax_reference_at_ragged_lengths(S, window,
                                                             cap):
    """The Pallas kernel needs S divisible by its blocks; the port takes
    any S. Held against the JAX package's dense reference instead."""
    rng = np.random.default_rng(S)
    dt = DTYPES[0]
    (jq, q), (jk, k), (jv, v) = (_both(rng, s, dt) for s in
                                 [(2, 8, S, 16), (2, 1, S, 16),
                                  (2, 1, S, 16)])
    want = jref.mha_reference(jq, jk, jv, window=window, softcap=cap)
    _close(flash_attention(q, k, v, window=window, softcap=cap), want,
           dt[0])


def test_wrappers_take_strided_views_and_out():
    """The model passes [B, S, H, d] activations and the [B, S, Kh, d]
    cache as transposed views and writes into a transposed ``out``."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 96, 4, 32, generator=g)
    k = torch.randn(2, 96, 2, 32, generator=g)
    v = torch.randn(2, 96, 2, 32, generator=g)
    out = torch.empty_like(q)
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), window=16,
                          out=out.transpose(1, 2))
    want = ref.mha_reference(q.transpose(1, 2).contiguous(),
                             k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(), window=16)
    assert got.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out.transpose(1, 2), want)
    lengths = torch.tensor([96, 5], dtype=torch.int32)
    dec = decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                           lengths)
    torch.testing.assert_close(dec, ref.decode_reference(
        q[:, 0].contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), lengths))


def test_wrappers_refuse_bad_arguments():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(NotImplementedError):
        flash_attention(q, kv, kv, causal=False)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError):
        flash_attention(q, kv.double(), kv.double())
    with pytest.raises(TypeError):
        decode_attention(q[:, :, 0], kv, kv, torch.ones(1))
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], kv, kv,
                         torch.ones(2, dtype=torch.int32))
