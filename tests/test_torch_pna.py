"""The port's PNA (``repro_torch.models.gnn.pna_forward``) and its segment
helpers against the JAX package's on the same float32 weights, carried
over with ``repro_torch.convert.gnn_params_from_reference``; the edge
chunks (cut at node boundaries) and chunked forwards against one chunk;
and a CPU rehearsal of ``chip_smoke.py``'s PNA checks.

Three configurations: ``reduce_config``'s (2 layers, hidden 16, d_feat 32,
5 classes) on ``cora_like(256, 1024)``, ``tests/test_distributed_paths.py``'s
(hidden 8, d_feat 16, 4 classes) on ``cora_like(64, 256)``, and the
published full-width config (4 layers, hidden 75) at full_graph_sm
(``cora_like(2708, 10556)``, d_feat 1,433). Edges are handed over unsorted
as generated. Logits agree within 1e-5 relative to max(1, max |logit|), as
``tests/test_torch_gnn.py`` holds GCN: both sides sum in float32 in other
orders, about 1e-7 apart.
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.registry import get_spec as j_get_spec  # noqa: E402
from repro.launch.train import reduce_config  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402

from repro_torch.convert import gnn_params_from_reference  # noqa: E402
from repro_torch.data.graphs import cora_like, random_graph  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RULES = AxisRules(batch=(), fsdp=None, tp=None)
RTOL = 1e-5
# chunked against one chunk: the same sums in the same order, but the CPU's
# GEMMs take other kernels for other row counts (~1e-7 apart)
CHUNK_RTOL = 1e-6


def _configs():
    """(name, JAX config, cora_like arguments) of the three configs."""
    published = j_get_spec("pna").config
    return {
        "reduced": (reduce_config(j_get_spec("pna")), (256, 1024, 0)),
        "distributed": (jgnn.GNNConfig(name="pna", model="pna", n_layers=2,
                                       d_hidden=8, n_species=8, n_classes=4,
                                       d_feat=16), (64, 256, 2)),
        "published": (dataclasses.replace(published, d_feat=1433),
                      (2708, 10556, 0)),
    }


def _port(jcfg, seed: int = 0):
    """The port's config and the JAX params in both packages."""
    cfg = tgnn.GNNConfig(**dataclasses.asdict(jcfg))
    jparams = jgnn.gnn_init(jcfg, jax.random.PRNGKey(seed))
    params = gnn_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, jparams, params


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", ["reduced", "distributed", "published"])
def test_pna_matches_jax(name):
    jcfg, (n, e, seed) = _configs()[name]
    cfg, jparams, params = _port(jcfg)
    data = cora_like(n, e, d_feat=cfg.d_feat, n_classes=cfg.n_classes,
                     seed=seed)
    edges = data["edge_index"]
    assert not (np.diff(edges[:, 1]) >= 0).all()      # handed over unsorted
    before = launch_counts()
    got = tgnn.pna_forward(cfg, params, torch.from_numpy(data["feat"]),
                           torch.from_numpy(edges))
    want = jgnn.pna_forward(jcfg, jparams, jnp.asarray(data["feat"]),
                            jnp.asarray(edges), RULES)
    assert got.shape == (n, cfg.n_classes)
    _close(got, want)
    assert launch_counts() == before      # the CPU takes the plain version


def test_segment_helpers_match_jax():
    """seg_max, seg_min, seg_mean and ``mp_aggregate(op="max")`` equal the
    reference's on sorted ids with empty segments (0 there, not -inf),
    into a fresh tensor or in place into a row slice."""
    rng = np.random.default_rng(5)
    n, E = 40, 300
    idx = np.sort(rng.integers(0, n, E)).astype(np.int32)
    idx[idx % 7 == 3] = 4                 # empty segments ...
    idx = np.sort(idx)
    x = rng.standard_normal((E, 6)).astype(np.float32) - 3.0   # ... below 0
    assert len(np.unique(idx)) < n
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    jx, ji = jnp.asarray(x), jnp.asarray(idx)
    np.testing.assert_array_equal(tgnn.seg_max(tx, ti, n).numpy(),
                                  np.asarray(jgnn.seg_max(jx, ji, n)))
    np.testing.assert_array_equal(tgnn.seg_min(tx, ti, n).numpy(),
                                  np.asarray(jgnn.seg_min(jx, ji, n)))
    np.testing.assert_array_equal(
        tgnn.mp_aggregate(tx, ti, n, op="max").numpy(),
        np.asarray(jgnn.mp_aggregate(jx, ji, n, RULES, op="max")))
    _close(tgnn.seg_mean(tx, ti, n), jgnn.seg_mean(jx, ji, n))
    _close(tgnn.mp_aggregate(tx, ti, n), jgnn.mp_aggregate(jx, ji, n, RULES))
    out = torch.full((n + 3, 6), 7.0)
    tgnn.seg_max(tx, ti, n, out=out[2:n + 2])
    np.testing.assert_array_equal(out[2:n + 2].numpy(),
                                  tgnn.seg_max(tx, ti, n).numpy())
    assert (out[:2] == 7).all() and (out[n + 2:] == 7).all()


def _check_plan(plan, dst: np.ndarray, n: int, cap: int) -> None:
    """Every edge and node in one chunk, in order; no run split; each
    chunk at most ``cap`` edges unless its edges are one node's run."""
    assert plan[0].e0 == 0 and plan[-1].e1 == len(dst)
    assert plan[0].lo == 0 and plan[-1].hi == n
    for a, b in zip(plan, plan[1:]):
        assert a.e1 == b.e0 and a.hi == b.lo
    for c in plan:
        assert c.lo < c.hi
        part = dst[c.e0:c.e1]
        assert ((part >= c.lo) & (part < c.hi)).all()
        if c.e1 - c.e0 > cap:
            assert len(np.unique(part)) == 1


@pytest.mark.parametrize("cap", [1, 37, 100, 2940, 10_000])
def test_edge_chunks_cut_at_node_boundaries(cap):
    edges = tgnn.sort_by_dst(torch.from_numpy(random_graph(300, 3000,
                                                           seed=3)))
    dst = edges[:, 1].contiguous()
    assert int(torch.bincount(dst).max()) > 100     # a hub past small caps
    plan = tgnn.edge_chunks(dst, 300, cap)
    _check_plan(plan, dst.numpy(), 300, cap)
    if cap >= len(dst):
        assert plan == [tgnn.EdgeChunk(0, len(dst), 0, 300)]
    else:
        assert any(c.e1 - c.e0 > cap for c in plan) == (cap < 260)
    empty = torch.zeros(0, dtype=torch.int32)
    assert tgnn.edge_chunks(empty, 5, cap) == [tgnn.EdgeChunk(0, 0, 0, 5)]
    with pytest.raises(ValueError):
        tgnn.edge_chunks(dst, 300, 0)


def test_pna_chunked_matches_one_chunk(monkeypatch):
    """A cap of 100 edges cuts the graph into 30 chunks, the hub (260
    edges) one of its own; the logits equal one chunk's within
    CHUNK_RTOL."""
    jcfg = _configs()["reduced"][0]
    cfg, _, params = _port(jcfg)
    rng = np.random.default_rng(1)
    feat = torch.from_numpy(rng.standard_normal((300, cfg.d_feat))
                            .astype(np.float32))
    edges = torch.from_numpy(random_graph(300, 3000, seed=3))
    whole = tgnn.pna_forward(cfg, params, feat, edges)
    monkeypatch.setattr(tgnn, "EDGE_CHUNK", 100)
    dst = tgnn.sort_by_dst(edges)[:, 1].contiguous()
    assert len(tgnn.edge_chunks(dst, 300)) == 30
    _close(tgnn.pna_forward(cfg, params, feat, edges), whole.numpy(),
           CHUNK_RTOL)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_pna_checks_on_cpu(monkeypatch):
    """The GNN phase's PNA checks on the CPU, with the plain versions on
    both sides: the card-vs-CPU logits at full_graph_sm; the two planted
    faults that must fail it (every node's first edge dropped; max taken
    with the zeroed rows); a chunked forward on a small power-law graph
    (no launches here), whose widths are those ``expected_widths``
    predicts."""
    smoke = _chip_smoke()
    cfg = smoke.gnn_config("pna", "full_graph_sm")
    assert cfg.d_feat == 1433 and cfg.d_hidden == 75
    check = smoke.gnn_model_check(cfg, seed=0, device="cpu")
    assert check["ok"] and check["max_abs_diff"] == 0.0
    assert check["nodes"] == 2708 and check["shape"] == "full_graph_sm"

    data = smoke.gnn_inputs(cfg, seed=0)
    params = tgnn.gnn_init(cfg, torch.Generator().manual_seed(0), "cpu")
    want = smoke.gnn_outputs(cfg, params, data, "cpu")["logits"]
    limit = smoke.SPARSE_MODEL_TOL * max(1.0, float(want.abs().max()))
    for name, fault in (("segment_sum_sorted", smoke._drop_run_starts),
                        ("seg_max", smoke._clamped_max)):
        with smoke.patched(tgnn, name, fault):
            got = smoke.gnn_outputs(cfg, params, data, "cpu")["logits"]
        assert float((got - want).abs().max()) > 100 * limit, name

    monkeypatch.setattr(tgnn, "EDGE_CHUNK", 5000)
    pcfg = dataclasses.replace(smoke.gnn_config("pna", "ogb_products"),
                               d_feat=12)
    graph = smoke.gnn_graph(3000, 40_000, 12, seed=1, device="cpu")
    params = tgnn.gnn_init(pcfg, torch.Generator().manual_seed(0), "cpu")
    res = smoke.gnn_serve(pcfg, params, graph, "cpu", calls=1)
    assert res["launches"] == {} and res["chunks"] > 1
    widths = smoke.segment_widths(pcfg, params, graph)
    want_widths = smoke.expected_widths(pcfg, res["chunks"])
    assert want_widths == {1: 1, 75: 2 * 4 * res["chunks"]}
    assert widths == dict.fromkeys(want_widths, 0)
