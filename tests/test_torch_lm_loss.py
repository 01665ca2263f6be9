"""The port's ``lm_loss`` and its attention gradient against the JAX
package on the CPU.

``lm_loss`` and every gradient of it at ``reduce_config`` of qwen3-0.6b
(qk norms, GQA), gemma2-2b (a window of 8 on the local layers, both
softcaps, sandwich norms, scaled embeddings) and granite-moe-1b (4
experts top-2, the Switch aux loss), on the same float32 weights
(``convert.lm_params_from_reference``) and tokens, against
``jax.value_and_grad(repro.models.transformer.lm_loss)``: the loss within
1e-5 relative, each gradient leaf within 1e-4 * max(1, max |g|) (float32
sums in another order).

``FlashAttention`` on the CPU (its plain forward and backward) against
``jax.grad`` of the reference's plain ``mha_reference``, and the backward
kernel's formulas (``chip_smoke.flash_bwd_math``: P from the row
log-sum-exp, Delta, the softcap's factor) against the same, with each of
its planted faults far outside; within 1e-5 * max(1, max |g|) (float32).
The card's element-wise bound of that backward (``chip_smoke.
flash_bwd_bound``) holds the formulas within 0.6 of it in bf16 and
float32, and puts each planted fault beyond twice it.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.registry import get_spec as j_get_spec  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.train import reduce_config as j_reduce  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs.registry import get_spec  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention, flash_attention_bwd)
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.runtime.train_loop import value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RULES = AxisRules(batch=(), fsdp=None, tp=None)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ATTN_GRAD_TOL = 1e-5


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def _grads_close(got: list, want: list, tol: float, labels=None):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (labels or {}).get(i, i)
        limit = tol * max(1.0, float(np.abs(w).max()) if w.size else 0.0)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= limit, (labels[i] if labels else i, err, limit)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b",
                                  "granite-moe-1b-a400m"])
def test_lm_loss_and_grads_match_jax(arch):
    jcfg = j_reduce(j_get_spec(arch))
    pcfg = reduce_config(get_spec(arch))
    assert (pcfg.n_layers, pcfg.d_model, pcfg.window, pcfg.n_experts) == \
        (jcfg.n_layers, jcfg.d_model, jcfg.window, jcfg.n_experts)
    jp = jtf.init_lm_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab, (2, 24)).astype(np.int32)

    def jloss(p):
        return jtf.lm_loss(jcfg, p, jnp.asarray(tokens), RULES)

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    pp = lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                  device="cpu", dtype=torch.float32)
    loss, aux, grads = value_and_grad(
        lambda p, b: ptf.lm_loss(pcfg, p, b), pp, torch.from_numpy(tokens))
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for key in ("nll", "aux"):
        assert abs(float(aux[key]) - float(jaux[key])) <= \
            LOSS_RTOL * max(1.0, abs(float(jaux[key])))
    if pcfg.moe:
        assert float(aux["aux"]) > 0
    paths = [tree.path_key(p) for p, _ in tree.flatten(grads)]
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert paths == jpaths
    _grads_close([g.numpy() for g in tree.leaves(grads)],
                 [np.asarray(x) for x in jax.tree.leaves(jg)], GRAD_TOL,
                 dict(enumerate(paths)))


def test_lm_loss_remats_each_layer_and_leaves_serving_alone():
    """The grad path checkpoints every layer (its forward runs again in
    the backward) and writes nothing in place into the params; the
    serving forward stays no-grad."""
    cfg = reduce_config(get_spec("gemma2-2b"))
    params = ptf.init_lm_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    before = [p.clone() for p in tree.leaves(params)]
    tokens = torch.randint(0, cfg.vocab, (1, 16))
    calls = []
    orig = FlashAttention.forward

    def counting(ctx, *a):
        calls.append(1)
        return orig(ctx, *a)

    FlashAttention.forward = staticmethod(counting)
    try:
        loss, _, grads = value_and_grad(
            lambda p, b: ptf.lm_loss(cfg, p, b), params, tokens)
    finally:
        FlashAttention.forward = staticmethod(orig)
    assert len(calls) == 2 * cfg.n_layers     # forward + recompute
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree.leaves(params)))
    assert all(torch.isfinite(g).all() for g in tree.leaves(grads))
    logits, _ = ptf.lm_forward(cfg, params, tokens)
    assert not logits.requires_grad


def _attn_inputs(seed, B, H, Hkv, S, d, cap):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, d)).astype(np.float32)
    if cap > 0:
        q *= cap / 2          # scores ~ N(0, (c/2)^2): the cap bites
    k = rng.normal(size=(B, Hkv, S, d)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, d)).astype(np.float32)
    do = rng.normal(size=(B, H, S, d)).astype(np.float32)
    return q, k, v, do


ATTN_CASES = [  # B, H, Hkv, S, d, window, softcap
    (1, 2, 2, 33, 16, 0, 0.0), (2, 4, 2, 50, 32, 0, 0.0),
    (1, 8, 2, 70, 16, 9, 0.0), (1, 4, 1, 65, 64, 0, 3.0),
    (2, 4, 2, 40, 32, 5, 2.0), (1, 2, 2, 1, 16, 0, 0.0),
    (1, 4, 4, 30, 16, 1, 0.0)]


def _jax_attn_grads(q, k, v, do, win, cap):
    def f(q_, k_, v_):
        o = jref.mha_reference(q_, k_, v_, True, win, cap)
        return jnp.sum(o * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_grads_match_jax(case):
    B, H, Hkv, S, d, win, cap = case
    q, k, v, do = _attn_inputs(sum(case[:5]), B, H, Hkv, S, d, cap)
    want = _jax_attn_grads(q, k, v, do, win, cap)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FlashAttention.apply(qt, kt, vt, win, cap)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jref.mha_reference(q, k, v, True, win, cap)),
        rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    _grads_close([g.numpy() for g in got], want, ATTN_GRAD_TOL)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_backward_kernel_formulas_match_jax(case):
    """What ``flash_bwd.cu`` computes (the row lse of the forward, Delta,
    dS with the softcap's factor) equals jax.grad; each planted fault is
    far outside."""
    smoke = _chip_smoke()
    B, H, Hkv, S, d, win, cap = case
    q, k, v, do = _attn_inputs(sum(case[:5]) + 1, B, H, Hkv, S, d, cap)
    want = _jax_attn_grads(q, k, v, do, win, cap)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = torch.empty((B, H, S))
    o = flash_attention(qt, kt, vt, window=win, softcap=cap, lse=lse)
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, H // Hkv, 1)) \
        * d ** -0.5
    if cap > 0:
        s = np.tanh(s / cap) * cap
    pos = np.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if win > 0:
        mask &= pos[None, :] > pos[:, None] - win
    lse_np = np.log(np.where(mask, np.exp(s - s.max(-1, keepdims=True)),
                             0).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_np, rtol=1e-5, atol=1e-5)
    got = smoke.flash_bwd_math(qt, kt, vt, o, dot, lse, win, cap)
    _grads_close([g.numpy() for g in got], want, ATTN_GRAD_TOL)
    scale = max(float(np.abs(w).max()) for w in want)
    for fault in (("softcap", "delta") if cap > 0 else ("delta",)):
        bad = smoke.flash_bwd_math(qt, kt, vt, o, dot, lse, win, cap, fault)
        worst = max(float(np.abs(g.numpy() - w).max())
                    for g, w in zip(bad, want))
        assert worst > 100 * ATTN_GRAD_TOL * scale, fault


BOUND_CASES = [  # B, H, Hkv, S, d, window, softcap, dtype
    (1, 4, 2, 300, 64, 0, 0.0, "bfloat16"),
    (1, 4, 2, 260, 128, 48, 20.0, "bfloat16"),
    (1, 4, 1, 200, 32, 0, 0.0, "float32")]


@pytest.mark.parametrize("case", BOUND_CASES)
def test_backward_bound_holds_formulas_and_fails_faults(case):
    """The card's element-wise check of ``flash_attention_bwd``
    (``chip_smoke.flash_bwd_bound``), rehearsed with the kernel's formulas
    (``flash_bwd_math``, Delta from the forward's rounded output) in the
    kernel's place: they pass it; the planted faults (Delta left out, dq
    of the later half of the rows off by BWD_LATE_ERR, and that half of dq
    zeroed) fail it."""
    smoke = _chip_smoke()
    B, H, Hkv, S, d, win, cap, name = case
    dtype = getattr(torch, name)
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in
                   _attn_inputs(S + d, B, H, Hkv, S, d, cap))
    lse = torch.empty((B, H, S))
    o = flash_attention(q, k, v, window=win, softcap=cap, lse=lse)
    want = ref.flash_attention_backward_reference(q, k, v, do, win, cap)
    bound = smoke.flash_bwd_bound(q, k, v, o, do, want, win, cap)
    got = smoke.flash_bwd_math(q, k, v, o, do, lse, win, cap)
    assert smoke.bwd_err(got, want, bound)[1] <= 0.6
    zeroed = got[0].clone()
    zeroed[:, :, S // 2:] = 0
    for bad in (smoke.flash_bwd_math(q, k, v, o, do, lse, win, cap,
                                     "delta"),
                smoke.late_rows_wrong(got), (zeroed, got[1], got[2])):
        assert smoke.bwd_err(bad, want, bound)[1] > 2.0


def test_flash_attention_bwd_wrapper_checks_and_cpu_route():
    q, k, v, do = (torch.from_numpy(x) for x in
                   _attn_inputs(0, 1, 4, 2, 20, 16, 0.0))
    lse = torch.empty((1, 4, 20))
    o = flash_attention(q, k, v, lse=lse)
    got = flash_attention_bwd(q, k, v, o, do, lse)
    want = ref.flash_attention_backward_reference(q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, do, lse[:, :2])
    with pytest.raises(ValueError):
        flash_attention(q, k, v, lse=torch.empty((1, 4, 20),
                                                 dtype=torch.float64))
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, o, do.double(), lse)
