"""The port's training substrate on the CPU: AdamW, EF compression,
checkpoints, fault tolerance, the train loop and launcher
(``repro_torch.optim``, ``repro_torch.runtime``,
``repro_torch.launch.train``), the matrices of ``tests/test_runtime.py``
held against the reference where both can take the same inputs (the
launcher's LM, recsys and GNN batches equal to the reference's stream, and
a smoke run of every family); and ``recsys_loss`` and ``EmbeddingBag``
against the JAX package.

Tolerances (float32): ten AdamW updates within 1e-6 of the reference's;
EF compression's int8 values and scales equal; checkpoints bit-exact in
both directions (bf16 too); ``recsys_loss`` within 1e-5 relative and its
gradients within 1e-4 * max(1, max |g|); ``EmbeddingBag``'s table
gradient within 1e-6 * max(1, max |g|) of ``jax.grad``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.registry import get_spec as j_get_spec  # noqa: E402
from repro.data.recsys import recsys_batch as j_recsys_batch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.train import (  # noqa: E402
    make_batch_iter as j_make_batch_iter)
from repro.launch.train import reduce_config as j_reduce  # noqa: E402
from repro.models import recsys as jrs  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs.registry import get_spec  # noqa: E402
from repro_torch.convert import (adamw_state_from_reference,  # noqa: E402
                                 recsys_params_from_reference)
from repro_torch.kernels.embedding_bag import (EmbeddingBag,  # noqa: E402
                                               embedding_bag_backward)
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     adamw_update, global_norm, lr_at)
from repro_torch.optim.compression import (  # noqa: E402
    dequantize_int8, ef_compress, ef_compress_tree, ef_decompress_tree,
    init_residuals, quantize_int8)
from repro_torch.runtime.checkpoint import (  # noqa: E402
    latest_step, restore_checkpoint, save_checkpoint)
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    StragglerMonitor, plan_mesh, simulate_failure, with_retries)
from repro_torch.runtime.train_loop import (  # noqa: E402
    TrainLoopConfig, make_train_step, train, value_and_grad)

RULES = AxisRules(batch=(), fsdp=None, tp=None)


def quad_loss(params, batch):
    err = params["w"] - batch["target"]
    return torch.sum(err * err), {"dummy": torch.zeros(())}


# -- the tree helper ----------------------------------------------------------

def test_tree_order_and_paths_are_jax_s():
    t = {"b": [torch.zeros(1), (torch.ones(2), torch.ones(3))],
         "a": {"y": torch.zeros(4), "x": torch.zeros(5)}}
    j = jax.tree.map(lambda x: np.asarray(x), {
        "b": [np.zeros(1), (np.ones(2), np.ones(3))],
        "a": {"y": np.zeros(4), "x": np.zeros(5)}})
    got = [(tree.path_key(p), tuple(x.shape)) for p, x in tree.flatten(t)]
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(j)[0]]
    assert got == want
    back = tree.unflatten(t, tree.leaves(t))
    assert list(back) == ["b", "a"] and isinstance(back["b"][1], tuple)
    assert tree.describe(t).startswith("{'a': {'x': *, 'y': *}")


def test_tree_leaves_are_freed_without_the_gc():
    """``flatten``, ``leaves``, ``unflatten`` and ``tree_map`` leave no
    reference cycle behind: with the GC off, a tree's tensors die with
    their last reference (a cycle held a 61-GB decode cache on the card
    until the GC ran)."""
    import gc
    import weakref
    t = {"a": [torch.zeros(3), torch.zeros(2)], "b": torch.zeros(1)}
    gc.disable()
    try:
        mapped = tree.tree_map(torch.neg, t)
        back = tree.unflatten(t, tree.leaves(mapped))
        refs = [weakref.ref(x) for x in tree.leaves(t) + tree.leaves(back)]
        del t, mapped, back
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# -- optimizer ----------------------------------------------------------------

def test_adamw_converges():
    cfg = AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0)
    params = {"w": torch.zeros(8)}
    target = torch.arange(8, dtype=torch.float32) / 8.0
    st = adamw_init(params)
    for _ in range(200):
        _, _, g = value_and_grad(quad_loss, params, {"target": target})
        params, st, info = adamw_update(cfg, g, st, params)
    assert float((params["w"] - target).abs().max()) < 0.05


def test_lr_schedule_shape_matches_reference():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                      end_lr_frac=0.1)
    jcfg = jadamw.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                              end_lr_frac=0.1)
    assert float(lr_at(cfg, torch.tensor(0))) == 0.0
    assert np.isclose(float(lr_at(cfg, torch.tensor(10))), 1.0)
    assert float(lr_at(cfg, torch.tensor(100))) <= 0.11
    assert float(lr_at(cfg, torch.tensor(55))) < 1.0
    for s in (0, 3, 10, 11, 55, 99, 100, 150):
        assert abs(float(lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
                   - float(jadamw.lr_at(jcfg, jnp.asarray(s)))) <= 1e-7


def test_adamw_bf16_params_fp32_moments():
    cfg = AdamWConfig(peak_lr=1e-2)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(params)
    assert st["m"]["w"].dtype == torch.float32
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    g = {"w": torch.ones(4, dtype=torch.bfloat16)}
    p2, st2, _ = adamw_update(cfg, g, st, params)
    assert p2["w"].dtype == torch.bfloat16
    assert int(st2["step"]) == 1
    jp, jst, _ = jadamw.adamw_update(
        jadamw.AdamWConfig(peak_lr=1e-2), {"w": jnp.ones(4, jnp.bfloat16)},
        jadamw.adamw_init({"w": jnp.ones(4, jnp.bfloat16)}),
        {"w": jnp.ones(4, jnp.bfloat16)})
    assert np.array_equal(p2["w"].float().numpy(),
                          np.asarray(jp["w"], np.float32))


def test_ten_adamw_updates_match_reference():
    """Random params and gradients (numpy), clipping active, decay on,
    chunked leaves: ten updates of both packages from the same state."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": {"c": (300,), "d": (3, 4, 2)},
              "e": [(11,), (2, 2)]}
    jparams = jax.tree.map(
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    cfg_kw = dict(peak_lr=0.05, warmup_steps=3, total_steps=20,
                  weight_decay=0.1, clip_norm=0.5)
    jcfg, cfg = jadamw.AdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    params = tree.tree_map(lambda x: torch.from_numpy(x.copy()),
                           jax.tree.map(np.asarray, jparams))
    jp = jax.tree.map(jnp.asarray, jparams)
    jst = jadamw.adamw_init(jp)
    st = adamw_state_from_reference(jax.tree.map(np.asarray, jst),
                                    device="cpu")
    import repro_torch.optim.adamw as padamw
    chunk, padamw.CHUNK = padamw.CHUNK, 64      # leaves updated in chunks
    try:
        for _ in range(10):
            g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
                np.float32), jparams)
            jp, jst, jinfo = jadamw.adamw_update(jcfg, g, jst, jp)
            params, st, info = adamw_update(
                cfg, tree.tree_map(torch.from_numpy,
                                   jax.tree.map(np.asarray, g)), st, params)
    finally:
        padamw.CHUNK = chunk
    assert int(st["step"]) == int(jst["step"]) == 10
    assert abs(float(info["grad_norm"]) - float(jinfo["grad_norm"])) <= \
        1e-6 * float(jinfo["grad_norm"])
    for got, want in zip(tree.leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    for got, want in zip(tree.leaves(st["v"]), jax.tree.leaves(jst["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-9)


def test_global_norm_chunks():
    import repro_torch.optim.adamw as padamw
    x = {"a": torch.arange(1000, dtype=torch.float32) / 100}
    whole = float(global_norm(x))
    chunk, padamw.CHUNK = padamw.CHUNK, 7
    try:
        assert abs(float(global_norm(x)) - whole) <= 1e-6 * whole
    finally:
        padamw.CHUNK = chunk


# -- compression --------------------------------------------------------------

def test_quantize_roundtrip_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 3, 1000).astype(np.float32))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_ef_compress_matches_reference():
    """Same int8 values, scales and residuals, with values on the .5
    rounding ties (half to even in both)."""
    rng = np.random.default_rng(2)
    jres = jnp.zeros(64, jnp.float32)
    tres = torch.zeros(64)
    for i in range(20):
        g = rng.normal(0, 1, 64).astype(np.float32)
        if i == 0:
            g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 58,
                         np.float32)
        jq, js, jres = jcomp.ef_compress(jnp.asarray(g), jres)
        q, s, tres = ef_compress(torch.from_numpy(g), tres)
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=0,
                                   atol=1e-6)


def test_error_feedback_accumulates():
    rng = np.random.default_rng(1)
    res = torch.zeros(64)
    true_sum = np.zeros(64)
    comp_sum = np.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(0, 1, 64).astype(np.float32))
        q, s, res = ef_compress(g, res)
        comp_sum += dequantize_int8(q, s).numpy()
        true_sum += g.numpy()
    assert np.abs(comp_sum + res.numpy() - true_sum).max() < 1e-3


def test_ef_tree_roundtrip():
    params = {"a": torch.ones(8), "b": {"c": torch.ones((2, 2))}}
    res = init_residuals(params)
    grads = tree.tree_map(lambda p: p * 0.37, params)
    q, s, res2 = ef_compress_tree(grads, res)
    deq = ef_decompress_tree(q, s)
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree.leaves(grads), tree.leaves(deq))) < 0.01
    assert list(q) == ["a", "b"] and q["b"]["c"].dtype == torch.int8


# -- checkpointing ------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6, dtype=torch.float32).view(2, 3)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, state)
    save_checkpoint(d, 9, tree.tree_map(lambda x: x + 1, state))
    assert latest_step(d) == 9
    step, restored = restore_checkpoint(d, state)
    assert step == 9
    assert torch.equal(restored["params"]["w"], state["params"]["w"] + 1)
    assert restored["opt"]["step"].dtype == torch.int32


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    state = {"x": torch.zeros(2)}
    for s in range(6):
        save_checkpoint(d, s, state, keep_last=2)
    kept = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    assert len(kept) == 2 and kept[-1] == "step_00000005"


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        restore_checkpoint(d, {"w": torch.zeros((3, 3))})
    with pytest.raises(KeyError):
        restore_checkpoint(d, {"v": torch.zeros((2, 2))})


def _cross_state(rng):
    w = rng.normal(size=(3, 5)).astype(np.float32)
    return {"params": {"w": w, "b16": (w[0] / 7).astype(jnp.bfloat16),
                       "layers": [w[1], w[2] * 3]},
            "opt": {"step": np.int32(4)}}


def test_checkpoint_cross_format_roundtrip(tmp_path):
    """The reference saves and the port restores, and the reverse:
    bit-exact, bf16 included; the manifests list the same keys."""
    rng = np.random.default_rng(5)
    jstate = jax.tree.map(jnp.asarray, _cross_state(rng))
    d1 = str(tmp_path / "ref_saved")
    jckpt.save_checkpoint(d1, 3, jstate)
    like = tree.tree_map(
        lambda x: torch.zeros(x.shape, dtype={
            "float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[str(x.dtype)]),
        jax.tree.map(np.asarray, jstate))
    step, got = restore_checkpoint(d1, like)
    assert step == 3
    for t, j in zip(tree.leaves(got), jax.tree.leaves(jstate)):
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16))
        else:
            assert np.array_equal(t.numpy(), np.asarray(j))

    d2 = str(tmp_path / "port_saved")
    save_checkpoint(d2, 5, got)
    step, back = jckpt.restore_checkpoint(d2, jstate)
    assert step == 5
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.atleast_1d(np.asarray(a)).view(np.uint8),
                              np.atleast_1d(np.asarray(b)).view(np.uint8))
    import json
    m1 = json.load(open(os.path.join(d1, "step_00000003", "manifest.json")))
    m2 = json.load(open(os.path.join(d2, "step_00000005", "manifest.json")))
    assert m1["keys"] == m2["keys"] and m2["version"] == 1


def test_checkpoint_bf16_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    state = {"w": torch.arange(8, dtype=torch.bfloat16) / 8.0,
             "m": torch.ones(4)}
    save_checkpoint(d, 1, state)
    step, restored = restore_checkpoint(d, state)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], state["w"])


# -- fault tolerance ----------------------------------------------------------

def test_retries():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert with_retries(flaky, n_retries=3)() == "ok"
    assert calls["n"] == 3
    with pytest.raises(ZeroDivisionError):
        with_retries(lambda: 1 / 0, n_retries=1)()


def _two_leaf_setup():
    target = {"target": torch.arange(6, dtype=torch.float32)}

    def loss(p, b):
        err = torch.cat([p["a"], p["b"]]) - b["target"]
        return torch.sum(err * err), {}

    def fresh():
        return {"a": torch.full((3,), 0.5), "b": torch.full((3,), -0.5)}

    opt = AdamWConfig(peak_lr=0.1, warmup_steps=0, weight_decay=0.01)
    p1, _, _ = make_train_step(loss, opt)(fresh(), adamw_init(fresh()),
                                          target)
    return target, loss, fresh, opt, p1


def test_train_retries_the_gradient_not_the_update(monkeypatch):
    """The update writes params and moments in place: an error part-way
    through it (here after the first leaf) propagates, with that leaf
    updated once and the rest untouched, and no second gradient or update
    is taken. An error in the gradient is retried and leaves the step as
    if it had not happened."""
    from repro_torch.optim import adamw as tadamw
    target, loss, fresh, opt, want = _two_leaf_setup()
    loop = TrainLoopConfig(total_steps=1, log_every=0, retries=1)

    params = fresh()
    calls = {"loss": 0, "armed": True}
    real_chunks = tadamw._chunks

    def chunks(t):
        if calls["armed"] and t is params["b"]:
            calls["armed"] = False
            raise RuntimeError("out of memory on the second leaf")
        return real_chunks(t)

    def counted(p, b):
        calls["loss"] += 1
        return loss(p, b)

    monkeypatch.setattr(tadamw, "_chunks", chunks)
    with pytest.raises(RuntimeError, match="second leaf"):
        train(counted, params, batches(target["target"]), opt, loop,
              log=lambda *a: None)
    assert calls["loss"] == 1
    assert torch.equal(params["a"], want["a"])
    assert torch.equal(params["b"], fresh()["b"])
    monkeypatch.setattr(tadamw, "_chunks", real_chunks)

    flaky = {"n": 0}

    def flaky_loss(p, b):
        flaky["n"] += 1
        if flaky["n"] == 1:
            raise RuntimeError("transient")
        return loss(p, b)

    res = train(flaky_loss, fresh(), batches(target["target"]), opt, loop,
                log=lambda *a: None)
    assert flaky["n"] == 2
    assert all(torch.equal(res.params[k], want[k]) for k in want)
    assert int(res.opt_state["step"]) == 1


def test_straggler_monitor():
    m = StragglerMonitor(factor=3.0)
    assert not any(m.observe(i, 0.1) for i in range(10))
    assert m.observe(10, 1.0)
    assert m.flagged_steps == [10]
    assert not m.observe(11, 0.1)
    d = StragglerMonitor(deadline_s=0.5)
    assert d.observe(0, 0.6) and not d.observe(1, 0.4)


def test_plan_mesh_elastic():
    assert plan_mesh(512, 16, pod_axis=2) == (2, 16, 16)
    assert plan_mesh(256, 16) == (16, 16)
    assert plan_mesh(208, 16) == (13, 16)
    with pytest.raises(ValueError):
        plan_mesh(8, 16)
    assert len(simulate_failure(list(range(512)), 256)) == 256
    with pytest.raises(ValueError):
        simulate_failure([0, 1], 2)


# -- train loop ---------------------------------------------------------------

def batches(target):
    while True:
        yield {"target": target}


def test_train_loop_runs_checkpoints_and_resumes(tmp_path):
    target = torch.arange(8, dtype=torch.float32)
    params = {"w": torch.zeros(8)}
    loop = TrainLoopConfig(total_steps=30, log_every=10, ckpt_every=10,
                           ckpt_dir=str(tmp_path / "ck"))
    opt = AdamWConfig(peak_lr=0.2, warmup_steps=2, total_steps=30,
                      weight_decay=0.0)
    l0 = float(quad_loss(params, {"target": target})[0])
    res = train(quad_loss, params, batches(target), opt, loop,
                log=lambda *a: None)
    assert latest_step(str(tmp_path / "ck")) == 30
    assert float(quad_loss(res.params, {"target": target})[0]) < l0 * 0.5
    assert [h["step"] for h in res.history] == [0, 10, 20]
    assert set(res.history[0]) >= {"loss", "grad_norm", "lr", "dummy",
                                   "seconds"}

    res2 = train(quad_loss, {"w": torch.zeros(8)}, batches(target), opt,
                 TrainLoopConfig(total_steps=35, ckpt_every=10,
                                 ckpt_dir=str(tmp_path / "ck")),
                 log=lambda *a: None)
    assert res2.resumed_from == 30
    assert int(res2.opt_state["step"]) == 35


def test_microbatch_accumulation_matches_large_batch():
    opt = AdamWConfig(peak_lr=0.1, warmup_steps=0, weight_decay=0.0)
    big = {"target": torch.stack([torch.ones(4), 3 * torch.ones(4)])}

    def loss_mean(p, b):
        err = p["w"][None, :] - b["target"]
        return torch.mean(torch.sum(err * err, -1)), {}

    params = {"w": torch.zeros(4)}
    p1, _, m1 = make_train_step(loss_mean, opt, 1)(
        params, adamw_init(params), big)

    def loss_micro(p, b):
        err = p["w"] - b["target"]
        return torch.sum(err * err), {}

    params = {"w": torch.zeros(4)}
    p2, _, m2 = make_train_step(loss_micro, opt, microbatches=2)(
        params, adamw_init(params), {"target": big["target"]})
    assert torch.allclose(p1["w"], p2["w"], atol=1e-6)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-6


# -- recsys_loss and the bag's gradient ---------------------------------------

def test_recsys_loss_and_grads_match_jax():
    jcfg = j_reduce(j_get_spec("wide-deep"))
    pcfg = ltrain.reduce_config(get_spec("wide-deep"))
    jp = jrs.init_recsys_params(jcfg, jax.random.PRNGKey(1))
    batch = j_recsys_batch(256, n_sparse=jcfg.n_sparse,
                           vocab=jcfg.vocab_per_field, n_dense=jcfg.n_dense,
                           seed=3)

    def jloss(p):
        return jrs.recsys_loss(jcfg, p, jax.tree.map(jnp.asarray, batch),
                               RULES)

    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    pp = recsys_params_from_reference(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux, grads = value_and_grad(
        lambda p, b: trs.recsys_loss(pcfg, p, b), pp, tb)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(aux["acc"]) == float(jaux["acc"])
    jflat = jax.tree.leaves(jg)
    assert len(jflat) == len(tree.leaves(grads))
    for (path, g), j in zip(tree.flatten(grads), jflat):
        j = np.asarray(j)
        limit = 1e-4 * max(1.0, float(np.abs(j).max()))
        assert float(np.abs(g.numpy() - j).max()) <= limit, path
    assert float(grads["candidates"].abs().max()) == 0.0


@pytest.mark.parametrize("combiner", ["mean", "sum"])
def test_embedding_bag_grad_matches_jax(combiner):
    """Rows repeated within and across bags, an empty bag, weights."""
    rng = np.random.default_rng(9)
    V, D, B, F, NNZ = 12, 5, 6, 3, 4
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, F, NNZ)).astype(np.int32)
    ids[0, 0] = 3                                  # one row four times
    mask = rng.choice([0.0, 0.5, 1.0, 2.0], (B, F, NNZ)).astype(np.float32)
    mask[1, 1] = 0.0                               # an empty bag
    gout = rng.normal(size=(B, F, D)).astype(np.float32)

    def f(t):
        return jnp.sum(jref.embedding_bag_reference(
            t, jnp.asarray(ids), jnp.asarray(mask), combiner) * gout)

    want = np.asarray(jax.grad(f)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = EmbeddingBag.apply(t, torch.from_numpy(ids),
                             torch.from_numpy(mask), combiner)
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(gout))
    assert float(np.abs(got.numpy() - want).max()) <= \
        1e-6 * max(1.0, float(np.abs(want).max()))
    direct = embedding_bag_backward(torch.from_numpy(gout),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(mask), V, combiner)
    assert torch.equal(direct, got)


def test_recsys_serving_path_takes_no_gradient():
    cfg = ltrain.reduce_config(get_spec("wide-deep"))
    params = trs.init_recsys_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    b = j_recsys_batch(8, n_sparse=cfg.n_sparse, vocab=cfg.vocab_per_field,
                       n_dense=cfg.n_dense, seed=0)
    out = trs.recsys_score(cfg, params, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
    assert not out.requires_grad


# -- the launcher -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "wide-deep", "gcn-cora",
                                  "pna", "egnn", "nequip"])
def test_launch_train_smoke_on_cpu(arch, tmp_path, capsys):
    res = ltrain.main(["--arch", arch, "--preset", "smoke", "--steps", "12",
                       "--batch", "4", "--device", "cpu", "--ckpt-dir",
                       str(tmp_path / "ck"), "--ckpt-every", "6"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "done: loss" in out
    assert [h["step"] for h in res.history] == [0, 10]
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert latest_step(str(tmp_path / "ck")) == 12
    if get_spec(arch).family == "gnn":      # one graph, every step
        assert res.history[-1]["loss"] < res.history[0]["loss"]


def test_launch_batches_are_the_reference_stream():
    for arch in ("qwen3-0.6b", "wide-deep"):
        spec, jspec = get_spec(arch), j_get_spec(arch)
        cfg, jcfg = ltrain.reduce_config(spec), j_reduce(jspec)
        it = ltrain.make_batch_iter(spec, cfg, 4, seed=7, device="cpu")
        jit_ = j_make_batch_iter(jspec, jcfg, 4, seed=7)
        for _ in range(2):
            got, want = next(it), next(jit_)
            if isinstance(got, dict):
                for k in want:
                    assert np.array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            else:
                assert got.dtype == torch.int32
                assert np.array_equal(got.numpy(), np.asarray(want))


def test_launch_gnn_batches_are_the_reference_stream():
    """Each GNN arch's batches equal the reference's ``make_batch_iter``
    stream (cora_like for GCN and PNA, molecule_batch for EGNN and NequIP,
    the same graph every step), key by key and dtype by dtype."""
    for arch in ("gcn-cora", "pna", "egnn", "nequip"):
        spec, jspec = get_spec(arch), j_get_spec(arch)
        cfg, jcfg = ltrain.reduce_config(spec), j_reduce(jspec)
        it = ltrain.make_batch_iter(spec, cfg, 4, seed=5, device="cpu")
        jit_ = j_make_batch_iter(jspec, jcfg, 4, seed=5)
        for _ in range(2):
            got, want = next(it), next(jit_)
            assert set(got) == set(want)
            for k in want:
                w = np.asarray(want[k])
                assert got[k].numpy().dtype == w.dtype, (arch, k)
                assert np.array_equal(got[k].numpy(), w), (arch, k)


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ltrain.main(["--arch", "wide-deep"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ltrain.main(["--arch", "gcn-cora"])
    spec = get_spec("pna")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(ltrain.make_batch_iter(spec, spec.config, 4))


# -- chip_smoke.py's train phase, rehearsed on the CPU ------------------------

def test_chip_smoke_train_checks_on_cpu(monkeypatch, tmp_path):
    """The train phase's checks at a tiny size on the CPU (the kernels'
    plain versions on both sides): the lm_loss check, a checkpoint round
    trip, and 5 AdamW steps of a reduced qwen3 and Wide&Deep whose losses
    fall. (The backward kernels' planted faults are rehearsed by
    ``tests/test_torch_lm_loss.py``.)"""
    import importlib
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(root)
    dev = torch.device("cpu")
    cfg = ltrain.reduce_config(get_spec(smoke.LM_ARCH))
    assert smoke.lm_loss_check(cfg, 0, dev)["ok"]
    from repro_torch.models.transformer import init_lm_params
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, dev)
    monkeypatch.setattr(smoke, "REPO", tmp_path)
    ck = smoke.checkpoint_check({"params": params,
                                 "opt": adamw_init(params)}, dev)
    assert ck["ok"], ck
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(smoke, "RECSYS_TRAIN_BATCH", 256)
    lm = smoke.lm_train(cfg, 0, dev)
    assert lm["ok"] and len(lm["losses"]) == smoke.TRAIN_STEPS
    rs = smoke.recsys_train(ltrain.reduce_config(get_spec("wide-deep")), 0,
                            dev)
    assert rs["ok"], rs["losses"]
