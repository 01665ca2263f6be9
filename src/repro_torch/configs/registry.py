"""Architecture lookup and serving shapes (port of the registry's archs
and shape tables, ``repro/configs/registry.py``).

Each arch module exposes ``spec() -> ArchSpec``. The port serves all ten
of the reference's archs: the dense and MoE LMs (qwen3, gemma2,
granite-moe, phi3.5-moe), the GNNs (PNA, EGNN, GCN, NequIP) and
Wide&Deep. The JAX registry's cell construction (abstract inputs and
shardings for the TPU dry run) is not ported (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

ARCH_IDS = [
    "phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m", "qwen3-0.6b",
    "qwen3-1.7b", "gemma2-2b",
    "pna", "egnn", "gcn-cora", "nequip",
    "wide-deep",
]

_MODULE_OF = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "granite-moe-1b-a400m": "granite_moe",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma2-2b": "gemma2_2b",
    "pna": "pna",
    "egnn": "egnn",
    "gcn-cora": "gcn_cora",
    "nequip": "nequip",
    "wide-deep": "wide_deep",
}

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, seq_shard=True),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556,
                          d_feat=1433),
    "minibatch_lg": dict(kind="sampled", n_nodes=184320, n_edges=169984,
                         d_feat=602, batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": dict(kind="full", n_nodes=2449029, n_edges=61859140,
                         d_feat=100),
    "molecule": dict(kind="molecule", n_graphs=128, nodes_per=30,
                     edges_per=64),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="score", batch=512),
    "serve_bulk": dict(kind="score", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


@dataclass
class ArchSpec:
    arch_id: str
    family: str                      # lm | gnn | recsys
    config: object
    skip_shapes: dict[str, str] = field(default_factory=dict)
    source: str = ""

    @property
    def shapes(self) -> dict:
        table = {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                 "recsys": RECSYS_SHAPES}[self.family]
        return {k: v for k, v in table.items() if k not in self.skip_shapes}


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULE_OF[arch_id]}")
    return mod.spec()
