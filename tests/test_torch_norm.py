"""The norm kernels' arithmetic on the CPU (``repro_torch.kernels.norm``,
``csrc/norm_kernels.cu``): a plain-torch emulation of each kernel (each
lane's rounded squares summed in column order, the lanes' sums in the
kernel's xor-shuffle tree and the warps' in order, the mean as the sum
times 1 / d, the products rounded one by one, the normalised value
rounded before RoPE and the rotation rounded once) held to the plain
``rms_norm`` + ``apply_rope`` and to the JAX model's qk-norm + RoPE on the
same numpy inputs, within ``chip_smoke.NORM_BAR``; the planted controls
of ``chip_smoke.check_norm_cases`` outside it; and the dispatch rule:
the CPU, the meta device and gradient-requiring inputs keep the plain
code, and the wrappers refuse what their kernels do not take."""

import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels import launch_counts, meta_ops, norm  # noqa: E402
from repro_torch.models import common  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


smoke = _smoke()
EPS = 1e-6


def _lane_tree(lanes: torch.Tensor) -> torch.Tensor:
    """The xor-shuffle tree over the last dim (the lanes of a group): at
    each step a lane adds the value of the lane ``o`` away, ``o`` from
    half the group down to 1; every lane ends with the same sum."""
    n = lanes.shape[-1]
    idx = torch.arange(n)
    o = n // 2
    while o:
        lanes = lanes + lanes[..., idx ^ o]
        o //= 2
    return lanes[..., 0]


def _chunk_sums(xf: torch.Tensor) -> torch.Tensor:
    """[..., C, 8] -> [..., C]: a chunk's 8 rounded squares added in
    column order from 0."""
    sq = xf * xf
    out = torch.zeros(sq.shape[:-1], dtype=torch.float32)
    for j in range(8):
        out = out + sq[..., j]
    return out


def _inv_rms(total: torch.Tensor, d: int) -> torch.Tensor:
    inv_d = torch.tensor(1.0, dtype=torch.float32) / d
    return torch.rsqrt(total * inv_d + EPS)


def emulate_rows(x: torch.Tensor, scale: torch.Tensor,
                 offset: float = 0.0) -> torch.Tensor:
    """``rms_norm_rows_kernel``'s arithmetic: W warps a row, lane (p, l)
    holding chunks p * 32 + l + c * 32 W (c < 4), its sum over its chunks
    in order, the warp's 32 lanes in the xor tree, the warps in order."""
    d = x.shape[-1]
    W, C = norm.row_warps(d), d // 8
    xf = x.float().reshape(-1, C, 8)
    chunks = _chunk_sums(xf)
    lanes = torch.zeros(xf.shape[0], W * 32)
    for c in range(norm.ROW_CHUNKS):
        idx = torch.arange(W * 32) + c * 32 * W
        add = torch.zeros_like(lanes)
        add[:, idx < C] = chunks[:, idx[idx < C]]
        lanes = lanes + add
    warps = _lane_tree(lanes.view(-1, W, 32))
    total = torch.zeros(xf.shape[0])
    for w in range(W):
        total = total + warps[:, w]
    r = _inv_rms(total, d)
    sc = scale.float() + offset if offset else scale.float()
    y = (xf.reshape(-1, d) * r[:, None]) * sc
    return y.to(x.dtype).reshape(x.shape)


def emulate_norm_rope(q, k, q_scale, k_scale, cos, sin, qk_norm: bool):
    """``norm_rope_kernel``'s arithmetic: a row's d / 8 lanes each sum
    their 8 rounded squares in order, then the xor tree over the group;
    the normalised value rounded to the dtype; each half rotated with
    separately rounded products and one rounding."""
    def one(x, scale):
        B, S, H, d = x.shape
        v = x.float()
        if qk_norm:
            total = _lane_tree(_chunk_sums(v.view(B, S, H, d // 8, 8)))
            r = _inv_rms(total, d)
            v = ((v * r[..., None]) * scale.float()).to(x.dtype).float()
        half = d // 2
        c = cos.expand(B, S, 1, half)
        s = sin.expand(B, S, 1, half)
        x1, x2 = v[..., :half], v[..., half:]
        a1, p1 = x1 * c, x2 * s
        a2, p2 = x2 * c, x1 * s
        return torch.cat([a1 - p1, a2 + p2], dim=-1).to(x.dtype)
    return one(q, q_scale), one(k, k_scale)


def _inputs(B, S, Hq, Hk, d, dtype, tables="model", scale_dtype=None,
            theta=1e6):
    gen = torch.Generator().manual_seed(0)
    return smoke.norm_inputs(gen, B, S, Hq, Hk, d, dtype, "cpu", tables,
                             scale_dtype, theta)


def _within(gap, dtype) -> None:
    assert smoke.within_norm_bar(gap, dtype), (gap, smoke.NORM_BAR)


ROPE_CASES = [(2, 512, 16, 8, 128, True, "model", None),
              (1, 1001, 16, 8, 64, False, "strided", None),
              (2, 100, 16, 8, 64, True, "shared", torch.bfloat16),
              (1, 77, 8, 4, 256, False, "model", None),
              (1, 130, 12, 4, 256, True, "strided", None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ROPE_CASES,
                         ids=lambda c: f"d{c[4]}-qk{int(c[5])}-{c[6]}")
def test_norm_rope_emulation_matches_plain(case, dtype):
    B, S, Hq, Hk, d, qk, tables, sd = case
    args = _inputs(B, S, Hq, Hk, d, dtype, tables, sd)
    want = norm.norm_rope_reference(*args, qk)
    gap = smoke.norm_case_gaps(emulate_norm_rope(*args, qk), want)
    _within(gap, dtype)
    if not qk:      # the rotation alone: the same roundings, bit for bit
        assert gap == (1.0, 0)


ROW_CASES = [(512, 1024, 0.0), (64, 2304, 1.0), (8, 8192, 0.0),
             (33, 1000, 0.0), (5, 8, 0.0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ROW_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}")
def test_rows_emulation_matches_plain(case, dtype):
    rows, d, offset = case
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((rows, d), generator=gen).to(dtype)
    scale = 1 + 0.5 * torch.randn(d, generator=gen)
    _within(smoke.ulp_gap(emulate_rows(x, scale, offset),
                          norm.rms_norm_reference(x, scale, offset=offset)),
            dtype)


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_rope_matches_the_jax_model(dtype, qk_norm):
    """The JAX model's ``rms_norm`` then ``rope`` on the same numpy
    inputs: the emulated kernel and the plain version within the bar of
    it, fed the JAX side's cos and sin (the port's ``rope_tables`` differ
    from them by up to ~60 float32 ulps at these positions, through the
    frequencies' powers); the rotation alone bit for bit."""
    B, S, Hq, Hk, d, theta = 2, 300, 16, 8, 128, 1e6
    q, k, qs, ks, _, _ = _inputs(B, S, Hq, Hk, d, dtype, theta=theta)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    half = d // 2
    freqs = theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    angles = pos[..., :, None].astype(jnp.float32) * freqs
    cos, sin = (torch.tensor(np.asarray(f(angles)))[:, :, None, :]
                for f in (jnp.cos, jnp.sin))

    def jax_side(x, scale):
        xj = jnp.asarray(x.float().numpy()).astype(jdt)
        if qk_norm:
            xj = jcommon.rms_norm(xj, jnp.asarray(scale.numpy()))
        out = jcommon.rope(xj, pos, theta)
        return torch.tensor(np.asarray(out.astype(jnp.float32))).to(dtype)

    want = (jax_side(q, qs), jax_side(k, ks))
    args = (q, k, qs, ks, cos, sin)
    for got in (emulate_norm_rope(*args, qk_norm),
                norm.norm_rope_reference(*args, qk_norm)):
        gap = smoke.norm_case_gaps(got, want)
        _within(gap, dtype)
        if not qk_norm:
            assert gap == (1.0, 0.0)


def test_planted_controls_fail_the_bar():
    """``chip_smoke.check_norm_cases``' controls are out of the bar on the
    CPU too: RoPE from the unrounded norm, and the mean square short of
    one lane's chunk."""
    args = _inputs(2, 512, 16, 8, 128, torch.bfloat16)
    want = norm.norm_rope_reference(*args, True)
    assert not smoke.within_norm_bar(smoke.norm_case_gaps(
        smoke.rounded_once_norm_rope(*args), want), torch.bfloat16)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((512, 1024), generator=gen).to(torch.bfloat16)
    scale = 1 + 0.5 * torch.randn(1024, generator=gen)
    assert not smoke.within_norm_bar(smoke.ulp_gap(
        smoke.short_mean_rms_norm(x, scale),
        norm.rms_norm_reference(x, scale)), torch.bfloat16)


def test_ulp_gap_counts_units_in_the_last_place():
    """Units at the element's magnitude, or at its RoPE pair's."""
    x = torch.tensor([1.0, -1.0, 0.0, 3.0], dtype=torch.bfloat16)
    up = x.view(torch.int16) + torch.tensor([1, 2, 0, 0],
                                            dtype=torch.int16)
    assert smoke.ulp_gap(up.view(torch.bfloat16), x) == (0.5, 2.0)
    assert smoke.ulp_gap(x, x) == (1.0, 0.0)
    assert smoke.ulp_gap(torch.tensor([-0.0]), torch.tensor([0.0]))[1] == 0
    # a cancelled element 2^-10 off: 2^-10 / 2^-7 of its pair's unit at 1
    want = torch.tensor([[2.0 ** -20, 1.0]])
    got = torch.tensor([[2.0 ** -20 + 2.0 ** -10, 1.0]])
    assert smoke.ulp_gap(got, want, pairs=True)[1] == 2.0 ** 13


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_keep_the_plain_code(device):
    """Off the card the model's norms take the plain versions: no launch,
    no meta operations, and on the CPU the same bits as them."""
    args = _inputs(2, 64, 16, 8, 128, torch.bfloat16)
    args = tuple(t.to(device) for t in args)
    x = torch.randn((2, 64, 1024)).to(torch.bfloat16).to(device)
    scale = torch.ones(1024, device=device)
    launches, ops = launch_counts(), meta_ops()
    assert not norm.takes_rows(x, scale)
    assert not norm.takes_norm_rope(*args)
    got = common.rms_norm(x, scale)
    assert launch_counts() == launches and meta_ops() == ops
    assert got.device.type == device and got.dtype == x.dtype
    if device == "cpu":
        assert torch.equal(got, norm.rms_norm_reference(x, scale))
        assert all(torch.equal(g, w) for g, w in zip(
            norm.norm_rope(*args, True),
            norm.norm_rope_reference(*args, True)))


def test_gradient_inputs_are_refused_only_under_autograd():
    x = torch.randn((4, 1024), requires_grad=True)
    scale = torch.ones(1024)
    assert "gradient" in norm.rows_refusal(x, scale)
    with pytest.raises(ValueError, match="gradient"):
        norm.rms_norm_rows(x, scale)
    with torch.no_grad():
        assert norm.rows_refusal(x, scale) is None
    q, k, qs, ks, cos, sin = _inputs(1, 8, 2, 2, 64, torch.float32)
    qs.requires_grad_()
    assert "gradient" in norm.norm_rope_refusal(q, k, qs, ks, cos, sin)
    with torch.no_grad():
        assert norm.norm_rope_refusal(q, k, qs, ks, cos, sin) is None


def _misaligned(shape):
    flat = torch.zeros(int(np.prod(shape)) + 1)
    return flat[1:].view(shape)


ROW_REFUSALS = {
    "width": (lambda: (torch.zeros(3, 1001), torch.ones(1001)), "width"),
    "too wide": (lambda: (torch.zeros(2, 8200), torch.ones(8200)), "width"),
    "dtype": (lambda: (torch.zeros(3, 64, dtype=torch.float16),
                       torch.ones(64)), "float16"),
    "scale dtype": (lambda: (torch.zeros(3, 64),
                             torch.ones(64, dtype=torch.float64)),
                    "float64"),
    "layout": (lambda: (torch.zeros(64, 3).T, torch.ones(64)),
               "contiguous"),
    "scale shape": (lambda: (torch.zeros(3, 64), torch.ones(32)), "scale"),
    "alignment": (lambda: (_misaligned((3, 64)), torch.ones(64)),
                  "aligned"),
}


@pytest.mark.parametrize("case", sorted(ROW_REFUSALS))
def test_rows_wrapper_refuses_what_its_kernel_does_not_take(case):
    make, words = ROW_REFUSALS[case]
    x, scale = make()
    with pytest.raises(ValueError, match=words):
        norm.rms_norm_rows(x, scale)
    assert not norm.takes_rows(x, scale)


def _rope_case(change):
    q, k, qs, ks, cos, sin = _inputs(1, 8, 4, 2, 128, torch.float32)
    args = dict(q=q, k=k, q_scale=qs, k_scale=ks, cos=cos, sin=sin)
    args.update(change(args))
    return args


ROPE_REFUSALS = {
    "head dim": (lambda a: {"q": torch.zeros(1, 8, 4, 96),
                            "k": torch.zeros(1, 8, 2, 96),
                            "cos": a["cos"][..., :48],
                            "sin": a["sin"][..., :48]}, "head dim"),
    "dtype": (lambda a: {"q": a["q"].half(), "k": a["k"].half()},
              "float16"),
    "mixed dtypes": (lambda a: {"k": a["k"].bfloat16()}, "k is"),
    "tokens": (lambda a: {"k": torch.zeros(1, 7, 2, 128)}, "match"),
    "layout": (lambda a: {"q": a["q"].transpose(1, 2).contiguous()
                          .transpose(1, 2)}, "contiguous"),
    "one scale": (lambda a: {"k_scale": None}, "k_scale"),
    "tables": (lambda a: {"cos": a["cos"].double()}, "float32"),
    "table shape": (lambda a: {"sin": a["sin"][:, :4]}, "broadcast"),
    "rank": (lambda a: {"q": a["q"][0]}, r"\[B, S, heads, d\]"),
}


@pytest.mark.parametrize("case", sorted(ROPE_REFUSALS))
def test_norm_rope_wrapper_refuses_what_its_kernel_does_not_take(case):
    change, words = ROPE_REFUSALS[case]
    a = _rope_case(change)
    with pytest.raises(ValueError, match=words):
        norm.norm_rope(a["q"], a["k"], a["q_scale"], a["k_scale"], a["cos"],
                       a["sin"], True)
    assert not norm.takes_norm_rope(a["q"], a["k"], a["q_scale"],
                                    a["k_scale"], a["cos"], a["sin"])


def test_norm_rope_without_qk_norm_ignores_scales_and_needs_both_with():
    q, k, qs, ks, cos, sin = _inputs(1, 8, 4, 2, 64, torch.bfloat16)
    got = norm.norm_rope(q, k, None, None, cos, sin, False)
    want = norm.norm_rope_reference(q, k, None, None, cos, sin, False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="qk_norm"):
        norm.norm_rope(q, k, None, None, cos, sin, True)


def test_row_warps_cover_every_width():
    for d in range(8, norm.ROW_WIDTH_MAX + 1, 8):
        w = norm.row_warps(d)
        assert d <= 8 * 32 * norm.ROW_CHUNKS * w
        assert w == 1 or d > 8 * 32 * norm.ROW_CHUNKS * (w // 2)
