"""The port's Wide&Deep (``repro_torch.models.recsys``) against the JAX
package's model on the same float32 weights, carried over with
``repro_torch.convert.recsys_params_from_reference``, and on the same
batch from the data generator both packages share; its refusals without
CUDA; and a CPU rehearsal of ``chip_smoke.py``'s recsys checks.

``reduce_config``'s wide-deep: 6 fields of 1,000 ids, embed 8, 4 dense
features, MLP 32-16, 500 candidates. Scores, logits and top-k scores agree
within 1e-5 relative; top-k indices are equal."""

import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.registry import RECSYS_SHAPES as J_RECSYS_SHAPES  # noqa: E402
from repro.configs.registry import get_spec as j_get_spec  # noqa: E402
from repro.data.recsys import recsys_batch as j_recsys_batch  # noqa: E402
from repro.launch.train import reduce_config  # noqa: E402
from repro.models import recsys as jrs  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402

from repro_torch.configs.registry import RECSYS_SHAPES  # noqa: E402
from repro_torch.convert import recsys_params_from_reference  # noqa: E402
from repro_torch.data.recsys import recsys_batch  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RULES = AxisRules(batch=(), fsdp=None, tp=None)
RTOL = 1e-5
BATCH = 64


@pytest.fixture(scope="module")
def tiny():
    """Tiny config, JAX params, the same params in the port, one batch."""
    jcfg = reduce_config(j_get_spec("wide-deep"))
    cfg = trs.RecsysConfig(**dataclasses.asdict(jcfg))
    jparams = jrs.init_recsys_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = recsys_params_from_reference(tree, device="cpu")
    batch = recsys_batch(BATCH, cfg.n_sparse, cfg.vocab_per_field,
                         cfg.nnz_per_field, cfg.n_dense, seed=3)
    return jcfg, cfg, jparams, params, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * max(1.0, np.abs(want).max()))


def test_data_and_shapes_match_reference():
    """The port's copy of the batch generator gives the reference's
    arrays; the shape table is the reference's."""
    for seed in (0, 5):
        mine = recsys_batch(17, 5, 300, 3, 4, seed=seed)
        ref = j_recsys_batch(17, 5, 300, 3, 4, seed=seed)
        assert mine.keys() == ref.keys()
        for k in mine:
            np.testing.assert_array_equal(mine[k], ref[k])
            assert mine[k].dtype == ref[k].dtype
    assert RECSYS_SHAPES == J_RECSYS_SHAPES


def test_converted_params_keep_layout(tiny):
    jcfg, cfg, jparams, params, _ = tiny
    assert params.keys() == jparams.keys()
    assert len(params["mlp"]) == len(jcfg.mlp_dims)
    for layer, jlayer in zip(params["mlp"], jparams["mlp"]):
        assert layer.keys() == {"w", "b"}
        assert tuple(layer["w"].shape) == jlayer["w"].shape
    for k in ("embed", "wide", "head", "bias", "candidates"):
        assert tuple(params[k].shape) == jparams[k].shape
        assert params[k].dtype == torch.float32


def test_score_and_logits_match_jax(tiny):
    jcfg, cfg, jparams, params, batch = tiny
    before = launch_counts()
    _close(trs.recsys_score(cfg, params, _tbatch(batch)),
           jrs.recsys_score(jcfg, jparams, _jbatch(batch), RULES))
    _close(trs.wide_deep_logits(cfg, params, _tbatch(batch)),
           jrs.wide_deep_logits(jcfg, jparams, _jbatch(batch), RULES))
    assert launch_counts() == before      # the CPU takes the plain version


@pytest.mark.parametrize("rows", [1, 3])
def test_retrieval_topk_matches_jax(tiny, rows):
    jcfg, cfg, jparams, params, batch = tiny
    one = {k: v[:rows] for k, v in batch.items()}
    vals, idx = trs.retrieval_topk(cfg, params, _tbatch(one), k=100)
    jvals, jidx = jrs.retrieval_topk(jcfg, jparams, _jbatch(one), RULES,
                                     k=100)
    assert vals.shape == (rows, 100)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(vals, jvals)


def test_model_embedding_bag_offsets_fields(tiny):
    """The model-level bag adds each field's offset into the unified table
    before the kernel wrapper, as the JAX function does."""
    jcfg, cfg, jparams, params, batch = tiny
    for combiner in ("mean", "sum"):
        got = trs.embedding_bag(params["embed"],
                                torch.from_numpy(batch["ids"]),
                                torch.from_numpy(batch["id_mask"]),
                                cfg.vocab_per_field, combiner)
        want = jrs.embedding_bag(jparams["embed"], jnp.asarray(batch["ids"]),
                                 jnp.asarray(batch["id_mask"]),
                                 jcfg.vocab_per_field, combiner)
        _close(got, want)


def test_entry_points_need_cuda_unless_asked(monkeypatch, tiny):
    jcfg, cfg, jparams, *_ = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trs.init_recsys_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        recsys_params_from_reference(
            jax.tree_util.tree_map(np.asarray, jparams))


def test_init_draws_the_reference_laws():
    """The port's random init has the JAX initialisers' shapes, dtypes and
    scales (its numbers differ: another generator)."""
    cfg = dataclasses.replace(trs.RecsysConfig(name="t"), n_sparse=4,
                              vocab_per_field=5000, n_candidates=4000)
    p = trs.init_recsys_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert float(p["embed"].std()) == pytest.approx(cfg.embed_dim ** -0.5,
                                                    rel=0.02)
    assert float(p["wide"].std()) == pytest.approx(0.01, rel=0.02)
    assert float(p["candidates"].std()) == pytest.approx(
        cfg.retrieval_dim ** -0.5, rel=0.02)
    assert float(p["mlp"][0]["w"].abs().max()) <= 2 * (
        cfg.n_sparse * cfg.embed_dim + cfg.n_dense) ** -0.5
    assert all(float(layer["b"].abs().max()) == 0 for layer in p["mlp"])


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_recsys_checks_on_cpu(monkeypatch):
    """The recsys phase's checks at a narrow wide-deep (40 fields of 1,000
    ids, the full MLP, 5,000 candidates) on the CPU, with the plain
    versions on both sides: card-vs-CPU logits, scores and top-k; a scored
    batch in [0, 1]; one retrieval; the embedding-bag row's exact,
    per-element and planted-fault checks."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(
        trs.RecsysConfig(name="t"), vocab_per_field=1000, n_candidates=5000)
    check = smoke.recsys_model_check(cfg, seed=0, device="cpu", batch=32)
    assert check["ok"] and check["max_abs_diff_logits"] == 0.0
    params = trs.init_recsys_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    res = smoke.recsys_serve(cfg, params, 48, seed=1, device="cpu", calls=1)
    assert res["launches"] == {} and res["samples_per_s"] > 0
    ret = smoke.recsys_retrieval(cfg, params, seed=2, device="cpu", calls=1)
    assert ret["launches"] == {} and ret["k"] == 100
    monkeypatch.setattr(smoke, "time_ms",         # CUDA events: card only
                        lambda fn, calls=1, reps=1: (fn(), 0.0)[1])
    data = smoke._recsys_inputs(cfg, 16, 3, "cpu")
    row = smoke.bag_kernel_row(cfg, params, data, {}, hbm=3.35e12)
    assert row["max_abs_err"] == 0.0 and row["bound_by"] == "bytes"
    assert set(row) == {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"}
