"""The port's MoE LM (``repro_torch.models.transformer``: ``_moe_route``,
``_moe_core``, ``moe_ffn`` and the model around them) against the JAX
package's on the same float32 weights, carried over with
``repro_torch.convert.lm_params_from_reference``.

Tiny configs: ``launch/train.py``'s ``reduce_config`` of granite-moe and
phi3.5-moe (2 layers, d_model 64, 4 experts, top-2, d_ff 32; granite ties
its head, phi has an ``lm_head``), and the config of
``tests/test_distributed_paths.py`` (d_model 32, capacity factor 2.0).
``_moe_core`` is held to the reference within 1e-4 (y) and 1e-6 (aux)
without drops, with drops (capacity factor 0.5) and in the short-group
branch (Tg = 8, C = 3), with the same experts chosen and the same number
of kept assignments; equal router probabilities pick the lower expert id,
as ``lax.top_k`` does; two expert slices sum to the whole; a dropped
assignment reads zeros; logits, aux and KV caches of prefill and decode
agree within 1e-4."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.registry import get_spec as j_get_spec  # noqa: E402
from repro.launch.train import reduce_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402

from repro_torch.configs.registry import get_spec  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = 1e-6
PROMPT = 128
STEPS = 8
ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]
# tests/test_distributed_paths.py's MoE config
DIST_CFG = jtf.LMConfig(name="m", n_layers=2, d_model=32, n_heads=4,
                        n_kv_heads=4, d_head=8, d_ff=16, vocab=211,
                        n_experts=4, top_k=2, capacity_factor=2.0)
# (Tg, capacity factor): C = 128 >= Tg (nothing can drop), C = 32 against
# a mean load of 64, and the short-group branch's max(1, ceil(K * 1.25))
CASES = {"no_drops": (128, 2.0), "drops": (128, 0.5), "short": (8, 1.25)}


def _jcfg(name):
    return DIST_CFG if name == "dist" else reduce_config(j_get_spec(name))


def _port(jcfg, **kw):
    return ttf.LMConfig(**{**dataclasses.asdict(jcfg), **kw})


def _params(jcfg):
    """JAX f32 params and the same params in the port, on the CPU."""
    jparams = jtf.init_lm_params(jcfg, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, lm_params_from_reference(tree, device="cpu",
                                             dtype=torch.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _layer0(params):
    lay = params["layers"]
    return [lay[k][0] for k in ("router", "wi_gate", "wi_up", "wo_ffn")]


def _jax_ids(jcfg, router, x):
    """The reference's expert choice: ``lax.top_k`` of the router softmax."""
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(x),
                                      jnp.asarray(router)), axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


def _kept(ids, E, C):
    """Kept assignments recomputed in numpy: per group and expert, the
    first C of its assignments."""
    return sum(int(np.minimum(np.bincount(g.ravel(), minlength=E), C).sum())
               for g in ids)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", ARCHS + ["dist"])
def test_moe_core_matches_jax(name, case):
    Tg, cf = CASES[case]
    jcfg = dataclasses.replace(_jcfg(name), capacity_factor=cf)
    cfg = _port(jcfg)
    jparams, params = _params(jcfg)
    x = np.random.default_rng(3).standard_normal(
        (2, Tg, jcfg.d_model)).astype(np.float32)
    want, jaux = jtf._moe_core(jcfg, *_layer0(jparams), jnp.asarray(x), 0)
    tx = torch.from_numpy(x)
    got, aux = ttf._moe_core(cfg, *_layer0(params), tx)
    _close(got, want)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    route = ttf._moe_route(cfg, params["layers"]["router"][0], tx, 0,
                           cfg.n_experts)
    ids = _jax_ids(jcfg, _layer0(jparams)[0], x)
    assert np.array_equal(route.ids.numpy(), ids)
    C = route.capacity
    assert C == {"no_drops": 128, "drops": 32, "short": 3}[case]
    kept = int(route.keep.sum())
    assert kept == _kept(ids, cfg.n_experts, C)
    A = 2 * Tg * cfg.top_k
    if case != "short":          # short groups may drop too: C = 3 < 2 K
        assert (kept == A) if case == "no_drops" else (kept < A)


def test_moe_top_k_ties_pick_the_lower_expert():
    """Router columns 1, 2 and 3 equal and largest, on dyadic x and router
    values, so the float32 logits (and the probabilities) tie exactly:
    every token takes experts 1 and 2, never 3, as ``lax.top_k`` does."""
    jcfg = reduce_config(j_get_spec(ARCHS[0]))
    cfg = _port(jcfg)
    jparams, params = _params(jcfg)
    rng = np.random.default_rng(5)
    d, E = jcfg.d_model, jcfg.n_experts
    x = rng.integers(1, 3, (2, 32, d)).astype(np.float32) / 4
    router = rng.integers(-2, 3, (d, E)).astype(np.float32) / 8
    router[:, 1:4] = 0.25
    ids = _jax_ids(jcfg, router, x)
    assert (ids == [1, 2]).all()
    _, wg, wu, wo = _layer0(jparams)
    want, jaux = jtf._moe_core(jcfg, jnp.asarray(router), wg, wu, wo,
                               jnp.asarray(x), 0)
    tx, trouter = torch.from_numpy(x), torch.from_numpy(router)
    route = ttf._moe_route(cfg, trouter, tx, 0, E)
    assert np.array_equal(route.ids.numpy(), ids)
    got, aux = ttf._moe_core(cfg, trouter, *_layer0(params)[1:], tx)
    _close(got, want)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


@pytest.mark.parametrize("case", ["no_drops", "drops"])
def test_moe_expert_slices_sum_to_the_whole(case):
    """Experts [0, 2) with e0 = 0 plus [2, 4) with e0 = 2 give the whole
    layer's output and the same aux, as the reference's expert shards sum
    under ``psum``."""
    Tg, cf = CASES[case]
    jcfg = dataclasses.replace(DIST_CFG, capacity_factor=cf)
    cfg = _port(jcfg)
    _, params = _params(jcfg)
    router, wg, wu, wo = _layer0(params)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, Tg, jcfg.d_model)).astype(np.float32))
    whole, aux = ttf._moe_core(cfg, router, wg, wu, wo, x)
    h = cfg.n_experts // 2
    lo, aux_lo = ttf._moe_core(cfg, router, wg[:h], wu[:h], wo[:h], x, 0)
    hi, aux_hi = ttf._moe_core(cfg, router, wg[h:], wu[h:], wo[h:], x, h)
    np.testing.assert_allclose((lo + hi).numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(aux_lo) == float(aux_hi) == float(aux)


def test_moe_dropped_assignments_read_zeros():
    """With drops, the last expert's output weights set to inf: a token
    none of whose kept assignments went to that expert stays finite, so a
    dropped assignment reads a zero row, never a real expert slot."""
    Tg, cf = CASES["drops"]
    jcfg = dataclasses.replace(DIST_CFG, capacity_factor=cf)
    cfg = _port(jcfg)
    _, params = _params(jcfg)
    router, wg, wu, wo = _layer0(params)
    wo = wo.clone()
    wo[-1] = float("inf")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, Tg, jcfg.d_model)).astype(np.float32))
    y, _ = ttf._moe_core(cfg, router, wg, wu, wo, x)
    r = ttf._moe_route(cfg, router, x, 0, cfg.n_experts)
    keep = torch.empty_like(r.keep).scatter_(1, r.order, r.keep)
    last = ((r.ids == cfg.n_experts - 1) & keep.view(r.ids.shape)).any(-1)
    dropped = ~keep.view(r.ids.shape).all(-1)
    assert bool((dropped & ~last).any())     # the case the test is about
    assert bool(torch.isfinite(y[~last]).all())


@pytest.fixture(scope="module", params=ARCHS)
def tiny(request):
    jcfg = _jcfg(request.param)
    jparams, params = _params(jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, PROMPT))
    return jcfg, _port(jcfg), jparams, params, tokens.astype(np.int32)


def test_moe_forward_matches_jax(tiny):
    """Prefill logits and the layers' mean aux loss (the prompt is longer
    than q_chunk: the reference's query-chunked branch)."""
    jcfg, cfg, jparams, params, tokens = tiny
    want, jaux = jtf.lm_forward(jcfg, jparams, jnp.asarray(tokens),
                                AxisRules())
    got, aux = ttf.lm_forward(cfg, params, torch.from_numpy(tokens))
    assert got.shape == (2, PROMPT, cfg.padded_vocab)
    _close(got, want)
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= AUX_TOL
    _close(ttf.lm_prefill(cfg, params, torch.from_numpy(tokens)), want)


def test_moe_decode_steps_match_jax(tiny):
    """8 decode steps from an empty cache (one token a group: C = 3):
    logits at every step and the final caches. A prefill with a cache
    writes the same K/V in layer 0, ahead of any FFN; later layers may
    differ, since an 8-token group's capacity (3 slots an expert) drops
    assignments that one-token groups keep."""
    jcfg, cfg, jparams, params, tokens = tiny
    jcache = jtf.init_kv_cache(jcfg, 2, 2 * STEPS, dtype=jnp.float32)
    cache = ttf.init_kv_cache(cfg, 2, 2 * STEPS, dtype=torch.float32,
                              device="cpu")
    step = jax.jit(lambda p, c, t, pos: jtf.lm_decode_step(
        jcfg, p, c, t, pos, AxisRules()))
    for t in range(STEPS):
        tok = tokens[:, t:t + 1]
        want, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.int32(t))
        got, _ = ttf.lm_decode_step(cfg, params, cache,
                                    torch.from_numpy(tok), t)
        _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    filled = ttf.init_kv_cache(cfg, 2, 2 * STEPS, dtype=torch.float32,
                               device="cpu")
    ttf.lm_prefill(cfg, params, torch.from_numpy(tokens[:, :STEPS]), filled)
    _close(filled["k"][0], jcache["k"][0])
    _close(filled["v"][0], jcache["v"][0])


def test_conversion_keeps_the_router_float32():
    jcfg = _jcfg(ARCHS[0])
    jparams = jtf.init_lm_params(jcfg, jax.random.PRNGKey(0),
                                 dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    bf = lm_params_from_reference(tree, device="cpu", dtype=torch.bfloat16)
    lay = bf["layers"]
    assert lay["router"].dtype == torch.float32
    assert lay["wi_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(lay["router"].numpy(),
                                  np.asarray(jparams["layers"]["router"]))


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_have_the_reference_tree(name):
    """The port's random MoE params: the reference's keys, shapes and
    dtypes (router float32 [L, d, E], experts [L, E, d, F] / [L, E, F, d]
    in the weights' dtype)."""
    jcfg = _jcfg(name)
    want = jax.eval_shape(lambda: jtf.init_lm_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    got = ttf.init_lm_params(_port(jcfg), torch.Generator().manual_seed(0),
                             torch.bfloat16, "cpu")
    flat_w = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
              for p, a in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {}
    for k, v in got.items():
        for kk, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            key = f"['{k}']" + (f"['{kk}']" if kk else "")
            flat_g[key] = (tuple(t.shape),
                           str(t.dtype).removeprefix("torch."))
    assert flat_g == flat_w


def test_serving_capacities():
    """C at the serving shapes: granite's 32k prefill (10,240 slots an
    expert) and one decode token a group (10 for granite, 3 for phi)."""
    granite = get_spec(ARCHS[0]).config
    phi = get_spec(ARCHS[1]).config
    assert ttf.moe_capacity(granite, 32768) == 10240
    assert ttf.moe_capacity(granite, 1) == 10
    assert ttf.moe_capacity(phi, 1) == 3
    assert ttf.moe_capacity(phi, 4096) == 640
    assert granite.active_param_count() == 428_658_688
    assert phi.active_param_count() == \
        j_get_spec(ARCHS[1]).config.active_param_count()
