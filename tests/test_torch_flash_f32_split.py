"""The arithmetic of the float32 tensor-core attention routes ("tc32":
``csrc/flash_f32_tc.cu`` and ``csrc/flash_bwd_f32_tc.cu``), emulated in
plain torch on the CPU, against the JAX package: its Pallas
``flash_attention`` in interpret mode and ``jax.grad`` of its
``chunked_causal_attention``.

The kernels cannot run here, so their arithmetic is emulated
(``repro_torch.kernels.ref``): each float32 operand split into three
bf16 pieces (``split3``, exact), each product the float32 sum of the six
bf16 products of ``SPLIT_TERMS``, P (and dS) split in three as well, the
forward by the kernel's key tiles with the online softmax. Held to the
card's float32 checks as they stand (``chip_smoke.ATTN_TOL["float32"]``
and ``chip_smoke.flash_bwd_bound``); a split one piece short
(``TWO_PIECE_TERMS``) must fail the forward's check on stated cases, and
the float64 yardstick (``chip_smoke.f32_err``) on a capped case passes the
plain version and fails the controls."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as pallas_flash  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402
from repro.models.transformer import chunked_causal_attention  # noqa: E402
from test_kernels import FLASH_CASES  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, TC32_HEAD_DIMS, TC32_KEY_TILE, bwd_route, flash_route,
    split_pieces)

ROOT = Path(__file__).resolve().parents[1]
# test_kernels.FLASH_CASES (B, H, Hkv, S, d, window, softcap) at each head
# dim of the float32 tensor-core routes
CASES = [(B, H, Hkv, S, d, win, cap)
         for (B, H, Hkv, S, _, win, cap) in FLASH_CASES
         for d in TC32_HEAD_DIMS]
# the backward's cases: three of those (GQA groups 2 and 1, a window, a
# softcap) and a ragged S off every tile; at d = 256 (gemma2's heads) a
# softcap of 50, a window and a ragged S off the 64-row tiles; at d = 16
# and 32 GQA groups 2 and 1, a window, softcaps and S off the 128-key
# (row) and 64-row (key) tiles
BWD_CASES = [(2, 4, 2, 128, 64, 0, 0.0), (1, 4, 4, 256, 128, 0, 50.0),
             (1, 2, 1, 64, 128, 32, 30.0), (1, 4, 2, 97, 64, 0, 0.0),
             (1, 4, 2, 128, 256, 0, 50.0), (1, 2, 1, 96, 256, 32, 0.0),
             (1, 4, 2, 97, 256, 0, 0.0),
             (2, 4, 2, 128, 16, 0, 0.0), (1, 4, 4, 256, 32, 0, 30.0),
             (1, 2, 1, 64, 32, 32, 0.0), (1, 4, 2, 97, 16, 0, 0.0),
             (1, 4, 2, 130, 32, 48, 20.0), (1, 2, 2, 193, 16, 0, 50.0)]
# the stated cases on which a split one piece short fails the forward check
CONTROL_CASE = (1, 4, 2, 256, 128, 0, 0.0)
CONTROL_CASE_256 = (1, 4, 2, 256, 256, 0, 0.0)      # gemma2's head dim
# at d = 16 and 32 the sums of S are 4 and 2 times shorter than at d = 64,
# and on CONTROL_CASE's 16,384 outputs the control's largest error can
# stay inside the check at d = 16; these are the shapes of the card's
# chip_smoke.TWO_PIECE_CASES at those head dims (qwen3's heads, S 1,024)
CONTROL_CASES_SMALL_D = [(1, 16, 8, 1024, d, 0, 0.0) for d in (16, 32)]
# a capped case of the backward check's kind (q scaled by c / 2), where the
# plain float32 version is itself off float64 and the float64 rule holds
YARDSTICK_CASE = (1, 4, 2, 256, 256, 0, 50.0)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small CPU ops: when the suite's
    workers share the CPU, torch's default thread pool made single tests
    many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def _inputs(case, seed, n=3, bite=False):
    """q, k, v (and dout with n = 4) as float32 numpy arrays of standard
    normals from ``seed``; with ``bite`` and a softcap, q scaled so that
    the cap bites, as ``chip_smoke.check_backward_cases`` scales it."""
    B, H, Hkv, S, d, _, cap = case
    rng = np.random.default_rng(seed)
    shapes = [(B, H, S, d), (B, Hkv, S, d), (B, Hkv, S, d), (B, H, S, d)]
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes[:n]]
    if bite and cap > 0:
        out[0] *= cap / 2
    return out


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint32)


def test_split3_is_exact_across_exponents_signs_and_ties():
    """hi + mid + lo == x bit for bit on float32 values with exponents from
    2^-100 to 2^100 and both signs, each piece as defined (hi the
    round-to-nearest-even bf16 of x, mid of x - hi, lo exactly x - hi -
    mid), and on values halfway between two bf16 values, which hi rounds
    to the even one."""
    rng = np.random.default_rng(0)
    n = 200_000
    x = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-100, 101, n)
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    # ties: the low 16 bits exactly 0x8000, odd and even bf16 neighbours
    ties = (_bits(x[:4096]) & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    x = np.concatenate([x, ties.view(np.float32)])
    xt = torch.from_numpy(x)
    hi, mid, lo = ref.split3(xt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.float() + mid.float()) + lo.float()
    assert np.array_equal(_bits(total.numpy()), _bits(x))
    # hi by round-to-nearest-even on the bits
    b = _bits(x).astype(np.uint64)
    rne = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint32) << 16
    assert np.array_equal(_bits(hi.float().numpy()), rne)
    r = xt - hi.float()
    assert torch.equal(mid, r.to(torch.bfloat16))
    assert torch.equal(lo.float(), r - mid.float())
    # the ties went to the even neighbour, and lo is never more than 8 bits
    tie_hi = _bits(hi[n:].float().numpy()) >> 16
    assert not np.any(tie_hi & 1)
    lo_bits = _bits(lo.float().numpy())
    assert np.all((lo_bits & 0xFFFF) == 0)


def test_split_pieces_layout_on_the_cpu():
    """``split_pieces`` (the pre-pass's wrapper) on CPU tensors of any
    strides and two head counts: one buffer, each source's pieces
    [3, B, heads, S, d] contiguous and equal to ``split3`` of it, the
    sources one after another."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 5, 4, 64)).astype(
        np.float32)).transpose(1, 2)                      # [2, 4, 5, 64]
    k = torch.from_numpy(rng.standard_normal((2, 2, 5, 64)).astype(
        np.float32) * 1e3)
    pieces = split_pieces(q, k)
    assert [tuple(p.shape) for p in pieces] == [(3, 2, 4, 5, 64),
                                               (3, 2, 2, 5, 64)]
    assert all(p.is_contiguous() and p.dtype == torch.bfloat16
               for p in pieces)
    assert pieces[1].data_ptr() == pieces[0].data_ptr() + 2 * q.numel() * 3
    for t, p in zip((q, k), pieces):
        for got, want in zip(p, ref.split3(t)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_split_forward_within_the_float32_check_of_pallas(case):
    """``mha_split_reference`` (the tc32 forward's arithmetic, its key tile
    at this d) against the Pallas kernel in interpret mode within
    ``ATTN_TOL["float32"]`` (|diff| <= 1e-5), and its lse against the
    plain version's."""
    smoke = _smoke()
    B, H, Hkv, S, d, win, cap = case
    qn, kn, vn = _inputs(case, S + d + H)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    got, lse = ref.mha_split_reference(q, k, v, win, cap, TC32_KEY_TILE[d])
    want = torch.from_numpy(np.array(pallas_flash(
        *(jnp.asarray(a) for a in (qn, kn, vn)), window=win, softcap=cap,
        bq=64, bk=64, interpret=True), np.float32))
    err, ratio = smoke.attn_err(got, want)
    lse_want = ref.mha_lse_reference(q, k, win, cap)
    lse_ratio = float(((lse - lse_want).abs() / (
        smoke.LSE_TOL * lse_want.abs().clamp(min=1.0))).max())
    print(f"{case}: max |split - pallas| {err}, {ratio}x ATTN_TOL; lse "
          f"{lse_ratio}x LSE_TOL")
    assert ratio <= 1.0
    assert lse_ratio <= 1.0


@pytest.mark.parametrize("case", BWD_CASES)
def test_split_backward_within_the_float32_bound_of_jax_grad(case):
    """``mha_split_backward_reference`` (the tc32 backward's arithmetic,
    from the plain forward's output and lse) against ``jax.grad`` of the
    JAX model's ``chunked_causal_attention`` on the same float32 values,
    element by element within ``flash_bwd_bound``'s float32 bound."""
    smoke = _smoke()
    B, H, Hkv, S, d, win, cap = case
    qn, kn, vn, don = _inputs(case, 2 * S + d, n=4, bite=True)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o = ref.mha_reference(q, k, v, True, win, cap)
    lse = ref.mha_lse_reference(q, k, win, cap)
    got = ref.mha_split_backward_reference(q, k, v, o, do, lse, win, cap)
    rules = AxisRules(batch=(), fsdp=None, tp=None)
    chunk = 32 if S % 32 == 0 else S

    def loss(q_, k_, v_):
        out = chunked_causal_attention(
            q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
            v_.transpose(0, 2, 1, 3), jnp.int32(win), cap or None, chunk,
            rules)
        return jnp.sum(out.transpose(0, 2, 1, 3) * don)

    want = [torch.from_numpy(np.array(g)) for g in jax.jit(jax.grad(
        loss, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (qn, kn, vn)))]
    bound = smoke.flash_bwd_bound(q, k, v, o, do, want, win, cap)
    ratios = [smoke.bwd_err((g,), (w,), (b,))[1]
              for g, w, b in zip(got, want, bound)]
    print(f"{case}: {ratios} (dq, dk, dv) of flash_bwd_bound")
    assert max(ratios) <= 1.0


def _two_piece_control(case):
    """(three, two): the three-piece split's and the two-piece control's
    ``attn_err`` ratios against the plain version on ``case``."""
    smoke = _smoke()
    B, H, Hkv, S, d, win, cap = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, 5))
    want = ref.mha_reference(q, k, v, True, win, cap)
    tile = TC32_KEY_TILE[d]
    three = smoke.attn_err(ref.mha_split_reference(q, k, v, win, cap,
                                                   tile)[0], want)[1]
    two = smoke.attn_err(ref.mha_split_reference(
        q, k, v, win, cap, tile, ref.TWO_PIECE_TERMS)[0], want)[1]
    print(f"{case}: three pieces {three}x, two pieces {two}x the "
          f"float32 tolerance")
    return three, two


def test_two_piece_split_fails_the_forward_check():
    """The control one piece short (hi.hi + hi.mid + mid.hi, P split in two
    as well) leaves about 2^-16 of each product: on CONTROL_CASE it is out
    of ``ATTN_TOL["float32"]``, where the three-piece split on the same
    inputs is well inside it. So the card's float32 check can see a split
    that is one piece short."""
    three, two = _two_piece_control(CONTROL_CASE)
    assert three <= 0.5
    assert two > 1.0


def test_two_piece_split_fails_the_forward_check_at_d256():
    """The same at gemma2's head dim (CONTROL_CASE_256, the d = 256 route's
    32-key tiles): the two-piece control out of ``ATTN_TOL["float32"]``,
    the three-piece split well inside it."""
    three, two = _two_piece_control(CONTROL_CASE_256)
    assert three <= 0.5
    assert two > 1.0


@pytest.mark.parametrize("case", CONTROL_CASES_SMALL_D)
def test_two_piece_split_fails_the_forward_check_at_d16_and_d32(case):
    """The same at d = 16 and 32 (the route's 128-key tiles) on
    CONTROL_CASES_SMALL_D: the two-piece control out of
    ``ATTN_TOL["float32"]``, the three-piece split well inside it."""
    three, two = _two_piece_control(case)
    assert three <= 0.5
    assert two > 1.0


def test_float64_yardstick_on_a_capped_case():
    """``chip_smoke.f32_err``'s rule on a capped case (q scaled by c / 2):
    the plain float32 version is more than half of ATTN_TOL's atol from
    float64 there, so the case is read against float64 (each element
    within atol plus the plain version's own error). The plain float32
    version passes it; the two-piece emulation and the plain version with
    PLANTED_DROP keys of each long row left out fail it. An uncapped case
    stays on the plain rule."""
    smoke = _smoke()
    B, H, Hkv, S, d, win, cap = YARDSTICK_CASE
    q, k, v = (torch.from_numpy(a)
               for a in _inputs(YARDSTICK_CASE, 11, bite=True))
    plain = ref.mha_reference(q, k, v, True, win, cap)
    exact = smoke.f64_reference(q, k, v, win, cap)
    own = float((plain.double() - exact).abs().max())
    tile = TC32_KEY_TILE[d]
    got = {
        "plain": plain,
        "two": ref.mha_split_reference(q, k, v, win, cap, tile,
                                       ref.TWO_PIECE_TERMS)[0],
        "dropped": ref.mha_reference(q, k, v, True,
                                     S - smoke.PLANTED_DROP, cap)}
    read = {name: smoke.f32_err(o, plain, exact) for name, o in got.items()}
    print(f"{YARDSTICK_CASE}: plain float32 {own} from float64; {read}")
    assert own > smoke.F64_SHARE * smoke.ATTN_TOL["float32"][0]
    assert all(rule == "float64" for _, _, rule in read.values())
    assert read["plain"][1] <= 1.0
    assert read["two"][1] > 1.0 and read["dropped"][1] > 1.0
    q0, k0, v0 = (torch.from_numpy(a) for a in _inputs(CONTROL_CASE_256, 5))
    plain0 = ref.mha_reference(q0, k0, v0)
    assert smoke.f32_err(plain0, plain0, smoke.f64_reference(
        q0, k0, v0))[2] == "plain"


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_routes_by_dtype_and_head_dim(d):
    """bf16 takes the bf16 tensor-core kernels at every head dim; float32
    takes the three-piece tensor-core routes at every head dim, forward and
    backward alike (the SIMT kernels are on no route)."""
    assert flash_route(torch.bfloat16, d) == "tc"
    assert bwd_route(torch.bfloat16, d) == "tc"
    assert d in TC32_HEAD_DIMS
    assert flash_route(torch.float32, d) == "tc32"
    assert bwd_route(torch.float32, d) == "tc32"
