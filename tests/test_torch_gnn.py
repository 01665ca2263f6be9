"""The port's GCN (``repro_torch.models.gnn``) against the JAX package's
model on the same float32 weights, carried over with
``repro_torch.convert.gnn_params_from_reference``, on the same graph from
the data generators both packages share; the edge sort; that PNA, EGNN
and NequIP build and run through ``gnn_init`` (``tests/test_torch_pna.py``
and ``tests/test_torch_equivariant.py`` hold them to JAX); the device
graph generator's law; and a CPU rehearsal of ``chip_smoke.py``'s GNN
checks.

``reduce_config``'s gcn-cora (2 layers, hidden 16, d_feat 32, 5 classes)
on ``cora_like(256, 1024)``, edges handed over unsorted as generated.
Logits agree within 1e-5 relative to max(1, max |logit|)."""

import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.registry import GNN_SHAPES as J_GNN_SHAPES  # noqa: E402
from repro.configs.registry import get_spec as j_get_spec  # noqa: E402
from repro.data.graphs import cora_like as j_cora_like  # noqa: E402
from repro.data.graphs import random_graph as j_random_graph  # noqa: E402
from repro.launch.train import reduce_config  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402

from repro_torch.configs.registry import GNN_SHAPES  # noqa: E402
from repro_torch.convert import gnn_params_from_reference  # noqa: E402
from repro_torch.data.graphs import (cora_like, power_law_graph,  # noqa: E402
                                     random_graph)
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RULES = AxisRules(batch=(), fsdp=None, tp=None)
RTOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    """Tiny config, JAX params, the same params in the port, one graph."""
    jcfg = reduce_config(j_get_spec("gcn-cora"))
    cfg = tgnn.GNNConfig(**dataclasses.asdict(jcfg))
    jparams = jgnn.gcn_init(jcfg, jax.random.PRNGKey(0))
    params = gnn_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    data = cora_like(256, 1024, d_feat=cfg.d_feat, n_classes=cfg.n_classes,
                     seed=0)
    return jcfg, cfg, jparams, params, data


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * max(1.0, np.abs(want).max()))


def test_data_and_shapes_match_reference():
    """The port's copies of the graph generators give the reference's
    arrays; the shape table is the reference's."""
    np.testing.assert_array_equal(random_graph(300, 2000, seed=4),
                                  j_random_graph(300, 2000, seed=4))
    mine, ref = cora_like(200, 900, 40, 5, seed=2), \
        j_cora_like(200, 900, 40, 5, seed=2)
    assert mine.keys() == ref.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k])
        assert mine[k].dtype == ref[k].dtype
    assert GNN_SHAPES == J_GNN_SHAPES


def test_forward_on_unsorted_edges_matches_jax(tiny):
    jcfg, cfg, jparams, params, data = tiny
    edges = data["edge_index"]
    assert not (np.diff(edges[:, 1]) >= 0).all()      # handed over unsorted
    before = launch_counts()
    got = tgnn.gcn_forward(cfg, params, torch.from_numpy(data["feat"]),
                           torch.from_numpy(edges))
    want = jgnn.gcn_forward(jcfg, jparams, jnp.asarray(data["feat"]),
                            jnp.asarray(edges), RULES)
    assert got.shape == (256, cfg.n_classes)
    _close(got, want)
    assert launch_counts() == before      # the CPU takes the plain version


def test_sort_by_dst_is_stable_and_leaves_the_result(tiny):
    _, cfg, _, params, data = tiny
    feat = torch.from_numpy(data["feat"])
    edges = torch.from_numpy(data["edge_index"])
    srt = tgnn.sort_by_dst(edges)
    assert tgnn.is_sorted_by_dst(srt) and not tgnn.is_sorted_by_dst(edges)
    order = np.argsort(data["edge_index"][:, 1], kind="stable")
    np.testing.assert_array_equal(srt.numpy(), data["edge_index"][order])
    _close(tgnn.gcn_forward(cfg, params, feat, srt),
           tgnn.gcn_forward(cfg, params, feat, edges).numpy())


def test_degrees_match_jax(tiny):
    data = tiny[-1]
    dst = np.sort(data["edge_index"][:, 1])
    got = tgnn.degrees(torch.from_numpy(dst), 256)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgnn.degrees(jnp.asarray(dst), 256)))
    assert got.dtype == torch.float32


def test_zoo_models_and_max_build_and_run(tiny):
    """PNA, EGNN and NequIP build through ``gnn_init`` and run on the CPU,
    ``mp_aggregate(op="max")`` takes each segment's max (0 where empty),
    and an unknown model name or op still raises."""
    cfg, data = tiny[1], tiny[-1]
    gen = torch.Generator().manual_seed(0)
    feat = torch.from_numpy(data["feat"])
    edges = torch.from_numpy(data["edge_index"])
    species = torch.randint(0, cfg.n_species, (256,), generator=gen,
                            dtype=torch.int32)
    coords = torch.randn((256, 3), generator=gen)
    for model in ("pna", "egnn", "nequip"):
        mcfg = dataclasses.replace(cfg, model=model)
        params = tgnn.gnn_init(mcfg, gen, "cpu")
        if model == "pna":
            out = [tgnn.pna_forward(mcfg, params, feat, edges)]
            assert out[0].shape == (256, cfg.n_classes)
        elif model == "egnn":
            out = tgnn.egnn_forward(mcfg, params, species, coords, edges)
        else:
            out = tgnn.nequip_forward(mcfg, params, species, coords,
                                      edges).values()
        assert all(bool(torch.isfinite(t).all()) for t in out)
    got = tgnn.mp_aggregate(torch.tensor([[1.0], [-3.0], [-2.0]]),
                            torch.tensor([0, 0, 2], dtype=torch.int32), 3,
                            op="max")
    assert got[:, 0].tolist() == [1.0, 0.0, -2.0]
    with pytest.raises(ValueError, match="unknown GNN model"):
        tgnn.gnn_init(dataclasses.replace(cfg, model="gat"),
                      torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="op"):
        tgnn.mp_aggregate(torch.zeros((3, 2)),
                          torch.zeros(3, dtype=torch.int32), 2, op="min")


def test_entry_points_need_cuda_unless_asked(monkeypatch, tiny):
    jparams, cfg = tiny[2], tiny[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgnn.gcn_init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn_params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                         jparams))


def test_power_law_graph_draws_random_graphs_law():
    """The device generator's law is numpy ``random_graph``'s: the hub's
    share of edge ends and the self-loop share agree within sampling
    noise at 200,000 draws."""
    n, e = 1000, 200_000
    got = power_law_graph(n, e, torch.Generator().manual_seed(0)).numpy()
    want = random_graph(n, e, seed=0)
    assert got.dtype == np.int32 and got.shape[1] == 2
    assert got.min() >= 0 and got.max() < n
    assert (got[:, 0] != got[:, 1]).all()
    assert abs(len(got) - len(want)) < 0.002 * e
    for col in (0, 1):
        share = np.bincount(got[:, col], minlength=n) / len(got)
        ref_share = np.bincount(want[:, col], minlength=n) / len(want)
        np.testing.assert_allclose(share[:5], ref_share[:5], rtol=0.05)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_gnn_checks_on_cpu(monkeypatch):
    """The GNN phase's checks on the CPU, with the plain versions on both
    sides: card-vs-CPU logits at full_graph_sm, a forward on a small
    power-law graph drawn and sorted by ``gnn_graph`` (three launches on a
    card, none here), the segment rows' exact, per-element and planted
    checks at the forward's three widths; and ``sum_err`` refusing a
    planted fault."""
    smoke = _chip_smoke()
    cfg = tgnn.GNNConfig(name="gcn-cora", model="gcn", n_layers=2,
                         d_hidden=16, n_classes=7, d_feat=1433)
    check = smoke.gnn_model_check(cfg, seed=0, device="cpu")
    assert check["ok"] and check["max_abs_diff"] == 0.0
    assert check["nodes"] == 2708
    pcfg = dataclasses.replace(cfg, d_feat=12)
    graph = smoke.gnn_graph(3000, 40_000, 12, seed=1, device="cpu")
    params = tgnn.gcn_init(pcfg, torch.Generator().manual_seed(0), "cpu")
    res = smoke.gnn_serve(pcfg, params, graph, "cpu", calls=1)
    assert res["launches"] == {} and res["max_in_degree"] > 100
    monkeypatch.setattr(smoke, "time_ms",         # CUDA events: card only
                        lambda fn, calls=1, reps=1: (fn(), 0.0)[1])
    widths = smoke.segment_widths(pcfg, params, graph)
    assert widths == {1: 0, 16: 0, 7: 0}
    rows = smoke.segment_kernel_rows(graph["edges"][:, 1].contiguous(),
                                     3000, widths, 3.35e12)
    assert [r["shape"].split()[-1] for r in rows] == ["D=16", "D=7", "D=1"]
    for row in rows:
        assert row["max_abs_err"] == 0.0
        assert row["name"] == "segment_sum_sorted" and row["launches"] == 0
    msg = torch.randn(5000, 4)
    dst = torch.sort(torch.randint(0, 50, (5000,))).values.to(torch.int32)
    want = tgnn.segment_sum_sorted(msg, dst, 50)
    bound = smoke.segment_bound(msg, dst, 50)
    assert smoke.sum_err(want, want, bound) == (0.0, 0.0)
    planted = tgnn.segment_sum_sorted(smoke.planted_segment(msg, dst), dst,
                                      50)
    assert smoke.sum_err(planted, want, bound)[1] > 1.0
