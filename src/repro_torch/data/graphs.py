"""Synthetic graphs of the GNN serving path (copies of ``random_graph``,
``cora_like`` and ``molecule_batch`` from ``repro/data/graphs.py``, numpy
only), and :func:`power_law_graph`, the same degree law drawn on the device
for graphs too large to draw on the host quickly. The reference's CSR
graph and neighbour sampler (``CSRGraph``, ``sample_neighbors``,
``pad_subgraph``, for the ``minibatch_lg`` shape) are not ported (ROADMAP
Queue 1 item 11)."""

from __future__ import annotations

import numpy as np
import torch


def random_graph(n_nodes: int, n_edges: int, seed: int = 0,
                 power: float = 0.8) -> np.ndarray:
    """Power-law-ish random digraph as an edge index [E, 2]."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_nodes + 1) ** power
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w)
    dst = rng.choice(n_nodes, size=n_edges, p=w)
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=1).astype(np.int32)


def cora_like(n_nodes: int = 2708, n_edges: int = 10556, d_feat: int = 1433,
              n_classes: int = 7, seed: int = 0) -> dict:
    """Cora-shaped synthetic citation graph with sparse binary features."""
    rng = np.random.default_rng(seed)
    edge_index = random_graph(n_nodes, n_edges, seed=seed)
    feat = (rng.random((n_nodes, d_feat)) < 0.012).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    mask = np.zeros(n_nodes, np.float32)
    mask[rng.choice(n_nodes, size=max(8, n_nodes // 20), replace=False)] = 1.0
    return {"feat": feat, "edge_index": edge_index, "labels": labels,
            "label_mask": mask}


def molecule_batch(batch: int = 128, n_nodes: int = 30, n_edges: int = 64,
                   n_species: int = 16, seed: int = 0) -> dict:
    """Batched small molecules: radius-graph-ish edges + synthetic energy."""
    rng = np.random.default_rng(seed)
    N = batch * n_nodes
    species = rng.integers(0, n_species, N).astype(np.int32)
    coords = rng.normal(0, 1.5, (N, 3)).astype(np.float32)
    edges = []
    for g in range(batch):
        base = g * n_nodes
        s = rng.integers(0, n_nodes, n_edges) + base
        d = rng.integers(0, n_nodes, n_edges) + base
        edges.append(np.stack([s, d], axis=1))
    edge_index = np.concatenate(edges).astype(np.int32)
    keep = edge_index[:, 0] != edge_index[:, 1]
    edge_index = edge_index[keep]
    graph_ids = np.repeat(np.arange(batch), n_nodes).astype(np.int32)
    energy = rng.normal(0, 1, batch).astype(np.float32)
    return {"species": species, "coords": coords, "edge_index": edge_index,
            "graph_ids": graph_ids, "energy": energy}

def power_law_graph(n_nodes: int, n_edges: int, generator: torch.Generator,
                    power: float = 0.8) -> torch.Tensor:
    """:func:`random_graph`'s law on ``generator``'s device: src and dst
    each drawn with probability proportional to ``1 / (k + 1) ** power`` by
    inverse-CDF sampling (``searchsorted`` of uniforms into the float64
    cumulative weights), self-loops dropped. Returns int32 [E', 2], E' <=
    ``n_edges``. Other draws than numpy's from the same seed; the same
    distribution."""
    dev = generator.device
    w = torch.arange(1, n_nodes + 1, dtype=torch.float64,
                     device=dev).pow_(-power)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()

    def draw():
        u = torch.rand(n_edges, dtype=torch.float64, device=dev,
                       generator=generator)
        return torch.searchsorted(cdf, u).clamp_(max=n_nodes - 1).to(
            torch.int32)

    src, dst = draw(), draw()
    keep = src != dst
    return torch.stack([src[keep], dst[keep]], dim=1)
