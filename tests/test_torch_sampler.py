"""The port's ``minibatch_lg`` sampler (``repro_torch.data.graphs``:
``CSRGraph``, ``sample_neighbors``, ``pad_subgraph``) against the JAX
package's numpy originals on the same ``np.random.default_rng`` seeds: the
CSR arrays, the sampled nodes (seeds first), the local edge index, the
seed count and the padded arrays and masks all equal, and the padding's
``ValueError`` the same; then a padded subgraph, sorted by ``sort_by_dst``,
through ``gcn_forward`` on the CPU against the unpadded subgraph.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import graphs as jgraphs  # noqa: E402

from repro_torch.data import graphs  # noqa: E402
from repro_torch.models import gnn  # noqa: E402


def _graph(n: int = 400, e: int = 3000, seed: int = 3):
    return jgraphs.random_graph(n, e, seed=seed), n


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_csr_graph_matches_reference():
    edges, n = _graph()
    got = graphs.CSRGraph.from_edges(edges, n)
    want = jgraphs.CSRGraph.from_edges(edges, n)
    assert got.n_nodes == want.n_nodes == n
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.indptr[-1] == len(edges)


@pytest.mark.parametrize("fanouts,seed", [((15, 10), 0), ((5,), 1),
                                          ((3, 3, 3), 2), ((50, 2), 3)])
def test_sample_neighbors_matches_reference(fanouts, seed):
    """The same draws from the same seeds: nodes, local edges and the seed
    count equal; seeds first; every local edge a real edge of the graph
    (message from neighbour to the seed side)."""
    edges, n = _graph()
    seeds = np.random.default_rng(seed).choice(n, 32, replace=False)
    got = graphs.sample_neighbors(graphs.CSRGraph.from_edges(edges, n),
                                  seeds, list(fanouts),
                                  np.random.default_rng(seed + 10))
    want = jgraphs.sample_neighbors(jgraphs.CSRGraph.from_edges(edges, n),
                                    seeds, list(fanouts),
                                    np.random.default_rng(seed + 10))
    _same(got, want)
    assert got["seed_count"] == 32
    np.testing.assert_array_equal(got["nodes"][:32], seeds)
    real = set(map(tuple, edges.tolist()))
    nodes = got["nodes"]
    assert all((int(nodes[d]), int(nodes[s])) in real
               for s, d in got["edge_index"])


def test_sample_neighbors_isolated_seeds():
    """Seeds with no out-edges sample nothing: an empty [0, 2] edge index,
    as the reference gives."""
    edges = np.array([[0, 1], [1, 2]], np.int32)
    seeds = np.array([3, 4])
    got = graphs.sample_neighbors(graphs.CSRGraph.from_edges(edges, 5),
                                  seeds, [4], np.random.default_rng(0))
    want = jgraphs.sample_neighbors(jgraphs.CSRGraph.from_edges(edges, 5),
                                    seeds, [4], np.random.default_rng(0))
    _same(got, want)
    assert got["edge_index"].shape == (0, 2)


def test_pad_subgraph_matches_reference():
    edges, n = _graph()
    seeds = np.arange(16)
    sub = jgraphs.sample_neighbors(jgraphs.CSRGraph.from_edges(edges, n),
                                   seeds, [6, 4], np.random.default_rng(5))
    n_pad, e_pad = len(sub["nodes"]) + 9, len(sub["edge_index"]) + 13
    got = graphs.pad_subgraph(sub, n_pad, e_pad)
    _same(got, jgraphs.pad_subgraph(sub, n_pad, e_pad))
    assert got["node_mask"].sum() == len(sub["nodes"])
    assert got["edge_mask"].sum() == len(sub["edge_index"])
    assert (got["edge_index"][len(sub["edge_index"]):] == n_pad - 1).all()
    for args in ((len(sub["nodes"]) - 1, e_pad),
                 (n_pad, len(sub["edge_index"]) - 1)):
        with pytest.raises(ValueError, match="exceeds padding") as exc:
            graphs.pad_subgraph(sub, *args)
        with pytest.raises(ValueError) as jexc:
            jgraphs.pad_subgraph(sub, *args)
        assert str(exc.value) == str(jexc.value)


def test_padded_subgraph_runs_through_gcn():
    """A sampled subgraph padded to static shapes and sorted by
    ``sort_by_dst`` runs through ``gcn_forward``: the real nodes' logits
    equal the unpadded subgraph's, except where the padding's self-loops
    on the dummy last node reach (that node alone)."""
    edges, n = _graph()
    csr = graphs.CSRGraph.from_edges(edges, n)
    sub = graphs.sample_neighbors(csr, np.arange(24), [8, 5],
                                  np.random.default_rng(7))
    n_real = len(sub["nodes"])
    padded = graphs.pad_subgraph(sub, n_real + 8, len(sub["edge_index"])
                                 + 40)
    cfg = gnn.GNNConfig(name="gcn", model="gcn", n_layers=2, d_hidden=16,
                        n_classes=5, d_feat=12)
    params = gnn.gcn_init(cfg, torch.Generator().manual_seed(0), "cpu")
    feat = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n + 1, 12)).astype(np.float32))[torch.from_numpy(padded["nodes"])]
    ei = gnn.sort_by_dst(torch.from_numpy(padded["edge_index"]))
    assert gnn.is_sorted_by_dst(ei)
    out = gnn.gcn_forward(cfg, params, feat, ei)
    assert out.shape == (n_real + 8, 5) and bool(torch.isfinite(out).all())
    want = gnn.gcn_forward(cfg, params, feat[:n_real],
                           torch.from_numpy(sub["edge_index"]))
    np.testing.assert_allclose(out[:n_real].numpy(), want.numpy(),
                               rtol=0, atol=1e-6)
