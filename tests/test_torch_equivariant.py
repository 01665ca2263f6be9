"""The port's EGNN and NequIP (``repro_torch.models.gnn``) against the JAX
package's on the same float32 weights, carried over with
``repro_torch.convert.gnn_params_from_reference``: forwards (EGNN's h and
coordinates, NequIP's l0, l1 and l2) and energies; their rotation
equivariance, with a planted fault that must break it; chunked forwards
against one chunk; ``molecule_batch`` against the reference's; the
converter on all four GNN trees; and a CPU rehearsal of ``chip_smoke.py``'s
EGNN and NequIP checks.

Three configurations: ``reduce_config``'s (2 layers, hidden 16) on
``molecule_batch(8, 12, 32)`` as ``reduce_config``'s batches come,
``tests/test_distributed_paths.py``'s (hidden 8, 8 species) on
``molecule_batch(4, 16, 32)``, and the published full-width configs (EGNN
4 layers, hidden 64; NequIP 5 layers, C = 32) at the molecule shape
(``molecule_batch(128, 30, 64)``). Species are drawn below the config's
``n_species``. Outputs agree within 1e-5 relative to max(1, max |output|),
as ``tests/test_torch_gnn.py`` holds GCN: both sides sum in float32 in
other orders, about 1e-7 apart.
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
from repro.data.graphs import molecule_batch as j_molecule_batch  # noqa: E402
from repro.launch.train import reduce_config  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402

from repro_torch.convert import gnn_params_from_reference  # noqa: E402
from repro_torch.data.graphs import molecule_batch, random_graph  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RULES = AxisRules(batch=(), fsdp=None, tp=None)
RTOL = 1e-5
# chunked against one chunk: the same sums in the same order, but the CPU's
# GEMMs take other kernels for other row counts (~1e-7 apart)
CHUNK_RTOL = 1e-6
# at x and at R x: R x rounds the coordinates, which the layers carry
# through (the worst output moved 1.5e-6 on the CPU); the planted
# permutation moves them by more than 0.1
ROT_RTOL = 2e-5
MODELS = ("egnn", "nequip")


def _config(model: str, name: str):
    """(JAX config, molecule_batch arguments: graphs, nodes, edges, seed)."""
    spec = j_get_spec(model)
    return {
        "reduced": (reduce_config(spec), (8, 12, 32, 0)),
        "distributed": (jgnn.GNNConfig(name=model, model=model, n_layers=2,
                                       d_hidden=8, n_species=8, n_classes=4,
                                       d_feat=16), (4, 16, 32, 2)),
        "published": (spec.config, (128, 30, 64, 0)),
    }[name]


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


def _outputs(cfg, params, data: dict) -> dict:
    """The port's forward outputs and energies on numpy ``data``."""
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    args = (cfg, params, t["species"], t["coords"], t["edge_index"])
    if cfg.model == "egnn":
        out = dict(zip(("h", "x"), tgnn.egnn_forward(*args)))
        energy = tgnn.egnn_energy
    else:
        out = tgnn.nequip_forward(*args)
        energy = tgnn.nequip_energy
    out["energy"] = energy(*args, t["graph_ids"], len(data["energy"]))
    return out


@pytest.mark.parametrize("name", ["reduced", "distributed", "published"])
@pytest.mark.parametrize("model", MODELS)
def test_forward_and_energy_match_jax(model, name):
    jcfg, (graphs, nodes, edges, seed) = _config(model, name)
    cfg, jparams, params = _port(jcfg)
    data = molecule_batch(graphs, nodes, edges, cfg.n_species, seed=seed)
    assert not (np.diff(data["edge_index"][:, 1]) >= 0).all()   # unsorted
    before = launch_counts()
    got = _outputs(cfg, params, data)
    assert launch_counts() == before      # the CPU takes the plain version
    j = {k: jnp.asarray(v) for k, v in data.items()}
    args = (jcfg, jparams, j["species"], j["coords"], j["edge_index"])
    if model == "egnn":
        want = dict(zip(("h", "x"), jgnn.egnn_forward(*args, RULES)))
        energy = jgnn.egnn_energy
    else:
        want = jgnn.nequip_forward(*args, RULES)
        energy = jgnn.nequip_energy
    want["energy"] = energy(*args, j["graph_ids"], graphs, RULES)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k])


def _rotation(seed: int) -> np.ndarray:
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else q * np.array([-1.0, 1.0, 1.0])


def _rotation_ratio(cfg, params, data: dict, R: np.ndarray) -> dict:
    """max |out(R x) - R out(x)| / (ROT_RTOL * max(1, max |R out(x)|)) per
    output: scalars invariant, vectors R v, l2 tensors R M R^T."""
    base = _outputs(cfg, params, data)
    got = _outputs(cfg, params, dict(
        data, coords=(data["coords"] @ R.T).astype(np.float32)))
    r = torch.from_numpy(R.astype(np.float32))
    want = dict(base)
    for k in ("x", "l1"):
        if k in want:
            want[k] = base[k] @ r.T
    if "l2" in want:
        want["l2"] = r @ base["l2"] @ r.T
    return {k: float((got[k] - want[k]).abs().max())
            / (ROT_RTOL * max(1.0, float(want[k].abs().max())))
            for k in want}


@pytest.mark.parametrize("model", MODELS)
def test_rotation_equivariance(model, monkeypatch):
    """At the published width, x -> R x leaves the energies invariant and
    turns coordinates, l1 and l2 with R; the edge vectors' components
    permuted (a fixed rotation that does not commute with R) break it."""
    cfg, _, params = _port(j_get_spec(model).config)
    data = molecule_batch(16, 30, 64, cfg.n_species, seed=4)
    R = _rotation(4)
    ratios = _rotation_ratio(cfg, params, data, R)
    assert max(ratios.values()) <= 1.0, ratios
    rel = tgnn._rel
    monkeypatch.setattr(tgnn, "_rel",
                        lambda pos, a, b: rel(pos, a, b)[:, [1, 2, 0]])
    planted = _rotation_ratio(cfg, params, data, R)
    assert max(planted[k] for k in ("x", "l1", "l2") if k in planted) > 100


@pytest.mark.parametrize("model", MODELS)
def test_chunked_matches_one_chunk(model, monkeypatch):
    """A cap of 100 edges cuts a 300-node power-law graph into 30 chunks,
    its hub (260 edges) one of its own; every output equals one chunk's
    within CHUNK_RTOL."""
    cfg, _, params = _port(_config(model, "reduced")[0])
    rng = np.random.default_rng(2)
    data = {"species": rng.integers(0, cfg.n_species, 300).astype(np.int32),
            "coords": rng.normal(0, 1.5, (300, 3)).astype(np.float32),
            "edge_index": random_graph(300, 3000, seed=3),
            "graph_ids": np.repeat(np.arange(3), 100).astype(np.int32),
            "energy": np.zeros(3, np.float32)}
    whole = _outputs(cfg, params, data)
    monkeypatch.setattr(tgnn, "EDGE_CHUNK", 100)
    dst = tgnn.sort_by_dst(torch.from_numpy(data["edge_index"]))[:, 1]
    assert len(tgnn.edge_chunks(dst.contiguous(), 300)) == 30
    got = _outputs(cfg, params, data)
    for k in whole:
        _close(got[k], whole[k].numpy(), CHUNK_RTOL)


def test_energies_sort_unsorted_graph_ids():
    """The per-graph sum takes ids ascending (one launch at D = 1) and sorts
    unsorted ones first: both give the sums of ``np.add.at``."""
    rng = np.random.default_rng(3)
    e_atom = rng.standard_normal(60).astype(np.float32)
    ids = np.repeat(np.arange(6), 10).astype(np.int32)
    want = np.zeros(6, np.float32)
    np.add.at(want, ids, e_atom)
    perm = rng.permutation(60)
    for order in (np.arange(60), perm):
        got = tgnn._graph_sum(torch.from_numpy(e_atom[order]),
                              torch.from_numpy(ids[order]), 6)
        _close(got, want, 1e-6)


def test_molecule_batch_matches_reference():
    mine = molecule_batch(9, 11, 20, n_species=7, seed=5)
    ref = j_molecule_batch(9, 11, 20, n_species=7, seed=5)
    assert mine.keys() == ref.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], ref[k])
        assert mine[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("arch", ["gcn-cora", "pna", "egnn", "nequip"])
def test_converter_carries_every_gnn_tree(arch):
    """The reference's tree of each model goes over leaf for leaf: the same
    nesting (dicts, lists, ``(w, b)`` tuples), shapes, dtypes and values,
    and ``gnn_init`` builds the port's own tree in the same layout."""
    jcfg = reduce_config(j_get_spec(arch))
    cfg = tgnn.GNNConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jgnn.gnn_init(jcfg, jax.random.PRNGKey(1)))
    got = gnn_params_from_reference(tree, device="cpu")
    mine = tgnn.gnn_init(cfg, torch.Generator().manual_seed(1), "cpu")
    flat, treedef = jax.tree_util.tree_flatten(tree)
    for port_tree in (got, mine):
        leaves, port_def = jax.tree_util.tree_flatten(port_tree)
        assert port_def == treedef
        for leaf, want in zip(leaves, flat):
            assert isinstance(leaf, torch.Tensor)
            assert tuple(leaf.shape) == want.shape
            assert leaf.dtype == torch.float32 and want.dtype == np.float32
    for leaf, want in zip(jax.tree_util.tree_leaves(got), flat):
        np.testing.assert_array_equal(leaf.numpy(), want)


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("pna", "egnn", "nequip"):
        cfg = tgnn.GNNConfig(name=model, model=model, n_layers=1, d_hidden=4)
        with pytest.raises(RuntimeError, match="CUDA"):
            tgnn.gnn_init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn_params_from_reference({"embed": np.zeros((2, 2), np.float32)})


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("model", MODELS)
def test_chip_smoke_equivariant_checks_on_cpu(model, monkeypatch):
    """The GNN phase's EGNN and NequIP checks on the CPU, with the plain
    versions on both sides: card-vs-CPU outputs at the molecule shape; the
    rotation check and its planted permutation, which fails it; the
    molecule-shape energies timed (no launches here); a chunked forward on
    a small power-law graph drawn by ``gnn_graph`` with species and
    coordinates, whose widths are those ``expected_widths`` predicts."""
    smoke = _chip_smoke()
    cfg = smoke.gnn_config(model, "molecule")
    check = smoke.gnn_model_check(cfg, seed=0, device="cpu")
    assert check["ok"] and check["max_abs_diff"] == 0.0
    assert check["nodes"] == 3840 and check["shape"] == "molecule"
    assert smoke.rotation_check(cfg, 0, "cpu")["ok"]
    assert not smoke.rotation_check(cfg, 0, "cpu", planted=True)["ok"]
    mol = smoke.gnn_molecule_latency(cfg, 0, "cpu", calls=1)
    assert mol["launches"] == {} and mol["graphs"] == 128

    monkeypatch.setattr(tgnn, "EDGE_CHUNK", 5000)
    graph = smoke.gnn_graph(3000, 40_000, 4, seed=1, device="cpu")
    assert graph["species"].dtype == torch.int32
    assert int(graph["species"].max()) < 16
    params = tgnn.gnn_init(cfg, torch.Generator().manual_seed(0), "cpu")
    res = smoke.gnn_serve(cfg, params, graph, "cpu", calls=1)
    assert res["launches"] == {} and res["chunks"] > 1
    widths = smoke.segment_widths(cfg, params, graph)
    want = smoke.expected_widths(cfg, res["chunks"])
    k = cfg.n_layers * res["chunks"]
    assert want == ({1: 1, 3: k, 64: k} if model == "egnn"
                    else {64: k, 288: k, 576: k})
    assert widths == dict.fromkeys(want, 0)
