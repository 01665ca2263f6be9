"""The port's dense LM (``repro_torch.models.transformer``) against the JAX
package's model on the same float32 weights, carried over with
``repro_torch.convert.lm_params_from_reference``; its configs (dense and
MoE) against the reference's; its refusal without CUDA; and a CPU
rehearsal of ``chip_smoke.py``'s LM and MoE checks. The MoE layers are
held to the reference in ``tests/test_torch_moe.py``.

Tiny qwen3- and gemma2-shaped configs (``launch/train.py``'s
``reduce_config`` sizes: 2 layers, d_model 64, 4 heads, d_head 16, window
8, q_chunk 64). The prompt of 128 tokens is longer than q_chunk, so the
JAX model takes its query-chunked attention branch; gemma2's even layer is
a sliding-window layer with softcaps. Logits and caches agree within
1e-4."""

import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.registry import LM_SHAPES as J_LM_SHAPES  # noqa: E402
from repro.configs.registry import get_spec as j_get_spec  # noqa: E402
from repro.launch.train import reduce_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402

from repro_torch.configs.registry import (ARCH_IDS, LM_SHAPES,  # noqa: E402
                                          get_spec)
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = 128
STEPS = 8


def _configs(arch):
    """(JAX config, port config) of the tiny arch, equal field by field."""
    jcfg = reduce_config(j_get_spec(arch))
    return jcfg, ttf.LMConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=["qwen3-0.6b", "gemma2-2b"])
def tiny(request):
    """Tiny config, JAX f32 params and the same params in the port."""
    jcfg, cfg = _configs(request.param)
    jparams = jtf.init_lm_params(jcfg, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = lm_params_from_reference(tree, device="cpu",
                                      dtype=torch.float32)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, PROMPT))
    return jcfg, cfg, jparams, params, tokens.astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_configs_match_reference():
    assert LM_SHAPES == J_LM_SHAPES
    for arch in ARCH_IDS:
        mine, ref = get_spec(arch), j_get_spec(arch)
        assert dataclasses.asdict(mine.config) == \
            dataclasses.asdict(ref.config)
        assert (mine.family, mine.source, mine.skip_shapes) == \
            (ref.family, ref.source, ref.skip_shapes)
        if hasattr(ref.config, "param_count"):     # GNNConfig has none
            assert mine.config.param_count() == ref.config.param_count()
        assert mine.shapes == ref.shapes
    assert get_spec("qwen3-0.6b").config.param_count() == 596_049_920
    assert get_spec("granite-moe-1b-a400m").config.param_count() == \
        1_334_628_352


def test_common_numerics_match_jax():
    """rms_norm (plain and Gemma's 1 + scale), rope, softcap and the
    activations against ``repro.models.common`` on the same inputs."""
    from repro.models import common as jc

    from repro_torch.models import common as tc
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    tx, ts, tp = (torch.from_numpy(a) for a in (x, scale, pos))
    for offset in (0.0, 1.0):
        _close(tc.rms_norm(tx, ts, offset=offset),
               jc.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                           offset=offset))
    _close(tc.rope(tx, tp, 1e6), jc.rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6))
    _close(tc.softcap(tx * 40, 30.0), jc.softcap(jnp.asarray(x) * 40, 30.0))
    assert tc.softcap(tx, None) is tx
    for name, fn in tc.ACTIVATIONS.items():
        _close(fn(tx), jc.ACTIVATIONS[name](jnp.asarray(x)))


def test_converted_params_keep_layout_and_norm_dtype(tiny):
    jcfg, cfg, jparams, params, _ = tiny
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1
                              for v in params.values())
    lay = params["layers"]
    assert tuple(lay["wq"].shape) == jparams["layers"]["wq"].shape
    bf = lm_params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device="cpu", dtype=torch.bfloat16)
    assert bf["layers"]["wq"].dtype == torch.bfloat16
    assert bf["layers"]["ln_attn"].dtype == torch.float32
    assert bf["final_norm"].dtype == torch.float32


def test_forward_matches_jax(tiny):
    jcfg, cfg, jparams, params, tokens = tiny
    assert PROMPT > jcfg.q_chunk
    want, _ = jtf.lm_forward(jcfg, jparams, jnp.asarray(tokens), AxisRules())
    got, aux = ttf.lm_forward(cfg, params, torch.from_numpy(tokens))
    assert got.shape == (2, PROMPT, cfg.padded_vocab)
    assert float(aux) == 0.0
    _close(got, want)
    _close(ttf.lm_prefill(cfg, params, torch.from_numpy(tokens)), want)


def test_decode_steps_match_jax(tiny):
    """8 decode steps from an empty cache: logits at every step and the
    final caches; the port's prefill with a cache writes the same K/V."""
    jcfg, cfg, jparams, params, tokens = tiny
    jcache = jtf.init_kv_cache(jcfg, 2, 2 * STEPS, dtype=jnp.float32)
    cache = ttf.init_kv_cache(cfg, 2, 2 * STEPS, dtype=torch.float32,
                              device="cpu")
    step = jax.jit(lambda p, c, t, pos: jtf.lm_decode_step(
        jcfg, p, c, t, pos, AxisRules()))
    for t in range(STEPS):
        tok = tokens[:, t:t + 1]
        want, jcache = step(jparams, jcache, jnp.asarray(tok),
                            jnp.int32(t))
        pos = t if t % 2 else torch.tensor(t)       # int or 0-dim tensor
        got, same = ttf.lm_decode_step(cfg, params, cache,
                                       torch.from_numpy(tok), pos)
        assert same is cache                          # updated in place
        _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    filled = ttf.init_kv_cache(cfg, 2, 2 * STEPS, dtype=torch.float32,
                               device="cpu")
    ttf.lm_prefill(cfg, params, torch.from_numpy(tokens[:, :STEPS]), filled)
    _close(filled["k"], jcache["k"])
    _close(filled["v"], jcache["v"])


def test_decode_past_the_cache_end():
    """qwen3 at ``max_seq`` 8, positions 0-9. The reference decodes all
    ten steps: its ``dynamic_update_slice`` clamps positions 8 and 9 onto
    the last slot and overwrites it. The port raises ``ValueError`` for an
    int ``pos`` of 8, 9 or -1 before writing anything, and with a 0-dim
    tensor ``pos`` below ``max_seq`` agrees with the reference."""
    jcfg, cfg = _configs("qwen3-0.6b")
    jparams = jtf.init_lm_params(jcfg, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    params = lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu",
        dtype=torch.float32)
    max_seq = 8
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab, (2, max_seq + 2)).astype(np.int32)
    jcache = jtf.init_kv_cache(jcfg, 2, max_seq, dtype=jnp.float32)
    cache = ttf.init_kv_cache(cfg, 2, max_seq, dtype=torch.float32,
                              device="cpu")
    step = jax.jit(lambda p, c, t, pos: jtf.lm_decode_step(
        jcfg, p, c, t, pos, AxisRules()))
    for t in range(max_seq + 2):
        tok = tokens[:, t:t + 1]
        last = np.asarray(jcache["k"][:, :, -1])
        want, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.int32(t))
        assert np.isfinite(np.asarray(want)).all()
        if t < max_seq:
            got, _ = ttf.lm_decode_step(cfg, params, cache,
                                        torch.from_numpy(tok),
                                        torch.tensor(t))
            _close(got, want)
            continue
        # the reference wrote this step's K/V over the last slot
        assert not np.array_equal(np.asarray(jcache["k"][:, :, -1]), last)
        before = {k: v.clone() for k, v in cache.items()}
        with pytest.raises(ValueError, match="outside"):
            ttf.lm_decode_step(cfg, params, cache, torch.from_numpy(tok), t)
        assert all(torch.equal(cache[k], before[k]) for k in cache)
    _close(cache["k"][:, :, :max_seq - 1],
           np.asarray(jcache["k"])[:, :, :max_seq - 1])
    with pytest.raises(ValueError, match="outside"):
        ttf.lm_decode_step(cfg, params, cache,
                           torch.from_numpy(tokens[:, :1]), -1)


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_lm_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        ttf.init_kv_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_reference({"embed": np.zeros((4, 4), np.float32)})


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_lm_checks_on_cpu():
    """The LM phase's checks at a tiny qwen3-shaped config on the CPU,
    with the plain versions on both sides: the card-vs-CPU logits check,
    the prefill pass, the decode loop with its greedy feedback and the
    decode-vs-prefill consistency check. The CPU launches no kernel."""
    smoke = _chip_smoke()
    _, cfg = _configs("qwen3-0.6b")
    check = smoke.lm_model_check(cfg, seed=0, device="cpu", prompt=16,
                                 steps=4)
    assert check["max_abs_diff"] == 0.0 and check["ok"]
    params = ttf.init_lm_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    pre = smoke.lm_prefill_phase(cfg, params, seq=24, batch=2, warm_seq=8,
                                 seed=0, device="cpu")
    assert pre["launches"] == {} and pre["tokens"] == 48
    dec = smoke.lm_decode_phase(cfg, params, batch=2, cache_len=20,
                                steps=4, seed=0, device="cpu")
    assert dec["launches"] == {} and dec["steps"] == 4
    assert dec["final_length"] == 20
    cons = smoke.lm_consistency(cfg, params, prompt=12, seed=0,
                                device="cpu")
    assert cons["max_abs_diff"] < 1e-4 and cons["argmax_agree"] == 1.0
    assert cons["off_by_one_control_diff"] > 1e-2


def test_chip_smoke_moe_checks_on_cpu():
    """The MoE phase's checks at the tiny granite config on the CPU, with
    the plain versions on both sides: the f32 check passes, with the same
    expert choices on both sides, and its planted routing fault (each
    token's K-th expert left out of the combine) fails the limit; the
    routing check with drops passes, and a planted off-by-one capacity
    fails it; decode against prefill at the ``no_drop`` capacity, with the
    prefill's expert choices forced and free."""
    smoke = _chip_smoke()
    _, cfg = _configs("granite-moe-1b-a400m")
    check = smoke.lm_model_check(cfg, seed=0, device="cpu", prompt=16,
                                 steps=4)
    assert check["max_abs_diff"] == 0.0 and check["ok"]
    assert check["routing_control_diff"] > check["limit"]
    assert check["flipped_calls"] == 0 and check["min_topk_gap"] > 0
    assert check["route_calls"] == cfg.n_layers * (1 + 4)
    drops = smoke.moe_drop_check(cfg, seed=0, device="cpu", groups=2,
                                 tokens=64)
    assert drops["ok"] and drops["kept"] < drops["assignments"]
    assert drops["capacity"] == 16 and drops["tied_kth"] > 0
    planted = smoke.moe_drop_check(cfg, seed=0, device="cpu", groups=2,
                                   tokens=64, planted=True)
    assert not planted["ok"] and planted["kept"] > planted["kept_recount"]
    params = ttf.init_lm_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    cons = smoke.lm_consistency(smoke.no_drop(cfg), params, prompt=12,
                                seed=0, device="cpu")
    assert cons["max_abs_diff"] < 1e-4 and cons["argmax_agree"] == 1.0
    assert cons["off_by_one_control_diff"] > 1e-2
    # in float32 the free decode chooses the prefill's experts
    assert cons["free_routing_changed"] == 0 and cons["routings"] == 24
    assert cons["free_routing_diff"] < 1e-4


def test_chip_smoke_attention_tolerance_on_cpu():
    """The per-element check that ``chip_smoke.py`` holds the attention
    kernels to passes the bf16 output's own rounding and fails the
    planted fault of its controls (the first keys of the longest rows
    left out), on the plain versions at bf16."""
    from repro_torch.kernels import ref
    smoke = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    S, n = 2048, smoke.PLANTED_DROP

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    q, k, v = rnd(1, 4, S, 64), rnd(1, 2, S, 64), rnd(1, 2, S, 64)
    want = ref.mha_reference(q, k, v)
    rounded = (want.float() * (1 + 2.0 ** -8)).to(torch.bfloat16)
    assert smoke.attn_err(rounded, want)[1] <= 1.0
    planted = ref.mha_reference(q, k, v, True, S - n)
    assert smoke.attn_err(planted, want)[1] > 1.0
    qd, lengths = rnd(2, 4, 64), torch.tensor([S, S], dtype=torch.int32)
    want = ref.decode_reference(qd, k.expand(2, -1, -1, -1),
                                v.expand(2, -1, -1, -1), lengths)
    planted = ref.decode_reference(qd, k.expand(2, -1, -1, -1),
                                   v.expand(2, -1, -1, -1), lengths, S - n)
    assert smoke.attn_err(want, want) == (0.0, 0.0)
    assert smoke.attn_err(planted, want)[1] > 1.0
