"""Graph datasets and neighbour sampling for GNN serving and training
(copies of ``repro/data/graphs.py``, numpy only): the synthetic generators
``random_graph``, ``cora_like`` and ``molecule_batch``; the CSR adjacency
:class:`CSRGraph` and the uniform fanout neighbour sampler
(:func:`sample_neighbors`, GraphSAGE style, the ``minibatch_lg`` shape's
data side) with :func:`pad_subgraph` to static shapes; and
:func:`power_law_graph`, ``random_graph``'s degree law drawn on the device
for graphs too large to draw on the host quickly."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class CSRGraph:
    indptr: np.ndarray      # [N+1]
    indices: np.ndarray     # [E] neighbor ids (outgoing)
    n_nodes: int

    @classmethod
    def from_edges(cls, edge_index: np.ndarray, n_nodes: int) -> "CSRGraph":
        src, dst = edge_index[:, 0], edge_index[:, 1]
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        indptr = np.searchsorted(src_s, np.arange(n_nodes + 1))
        return cls(indptr=indptr, indices=dst_s, n_nodes=n_nodes)


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


# ---------------------------------------------------------------------------
# neighbor sampler (GraphSAGE fanout sampling)
# ---------------------------------------------------------------------------

def sample_neighbors(g: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                     rng: np.random.Generator) -> dict:
    """K-hop uniform neighbor sampling.

    Returns a node-induced sampled subgraph with *local* ids:
    {nodes (global ids, seeds first), edge_index (local), seed_count}.
    """
    nodes = list(seeds.tolist())
    local = {int(v): i for i, v in enumerate(nodes)}
    edges_src: list[int] = []
    edges_dst: list[int] = []
    frontier = list(seeds.tolist())
    for fanout in fanouts:
        nxt: list[int] = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(fanout, deg)
            picks = rng.choice(deg, size=take, replace=False)
            for nb in g.indices[lo + picks]:
                nb = int(nb)
                if nb not in local:
                    local[nb] = len(nodes)
                    nodes.append(nb)
                    nxt.append(nb)
                # message flows neighbor -> seed side (dst = v)
                edges_src.append(local[nb])
                edges_dst.append(local[v])
        frontier = nxt
    edge_index = (np.stack([np.asarray(edges_src), np.asarray(edges_dst)],
                           axis=1).astype(np.int32)
                  if edges_src else np.zeros((0, 2), np.int32))
    return {"nodes": np.asarray(nodes, dtype=np.int64),
            "edge_index": edge_index,
            "seed_count": len(seeds)}


def pad_subgraph(sub: dict, n_nodes_pad: int, n_edges_pad: int) -> dict:
    """Pad a sampled subgraph to static shapes.

    Padding edges are self-loops on a dummy last node, so segment ops stay
    correct; ``node_mask``/``edge_mask`` mark real entries.
    """
    nodes = sub["nodes"]
    ei = sub["edge_index"]
    n, e = len(nodes), len(ei)
    if n > n_nodes_pad or e > n_edges_pad:
        raise ValueError(f"subgraph ({n} nodes, {e} edges) exceeds padding "
                         f"({n_nodes_pad}, {n_edges_pad})")
    nodes_p = np.zeros(n_nodes_pad, dtype=np.int64)
    nodes_p[:n] = nodes
    ei_p = np.full((n_edges_pad, 2), n_nodes_pad - 1, dtype=np.int32)
    ei_p[:e] = ei
    node_mask = np.zeros(n_nodes_pad, np.float32)
    node_mask[:n] = 1.0
    edge_mask = np.zeros(n_edges_pad, np.float32)
    edge_mask[:e] = 1.0
    return {"nodes": nodes_p, "edge_index": ei_p, "node_mask": node_mask,
            "edge_mask": edge_mask, "seed_count": sub["seed_count"]}


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
