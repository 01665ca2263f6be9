"""GCN inference over destination-sorted edges (port of the GCN path of
``repro/models/gnn.py``).

Every aggregation runs through the ``segment_sum_sorted`` kernel, which
takes edges sorted by destination: :func:`sort_by_dst` sorts a graph once
(stable), and :func:`gcn_forward` sorts edges it is handed unsorted. One
forward launches the kernel ``n_layers + 1`` times: the degrees, then each
layer's messages.

Names and layouts at the public functions are the JAX module's: features
[N, F], ``edge_index`` int32 [E, 2] (src, dst), params ``{"w": [...]}``.
Where the port differs, by design: there is no sharding (``AxisRules``),
as it serves from one card; the forward computes the symmetric edge norms
once for all layers (the JAX module recomputes them per layer, with the
same operations) and scales the gathered messages in place; PNA, EGNN,
NequIP, ``segment_max`` and ``gnn_loss`` are not ported yet (ROADMAP
Queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..kernels.segment_mp import segment_sum_sorted
from .common import dense_init

_UNPORTED = ("not ported yet (ROADMAP Queue 1: PNA, EGNN and NequIP with "
             "segment_max/segment_min)")


@dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str                  # gcn | pna | egnn | nequip
    n_layers: int
    d_hidden: int
    n_classes: int = 16
    d_feat: int = 128
    n_species: int = 16         # equivariant models: atom-type vocabulary
    l_max: int = 2              # nequip
    n_rbf: int = 8              # nequip
    cutoff: float = 5.0         # nequip
    aggregators: tuple[str, ...] = ("mean", "max", "min", "std")  # pna
    scalers: tuple[str, ...] = ("identity", "amplification", "attenuation")


def sort_by_dst(edge_index: torch.Tensor) -> torch.Tensor:
    """edge_index [E, 2] (src, dst) -> the same edges ordered by dst, ties
    in their original order: the layout the segment kernel takes. Done once
    per graph."""
    order = torch.sort(edge_index[:, 1], stable=True).indices
    return edge_index[order]


def is_sorted_by_dst(edge_index: torch.Tensor) -> bool:
    """Whether dst is ascending (one device reduction, one host sync)."""
    dst = edge_index[:, 1]
    return bool((dst[1:] >= dst[:-1]).all())


def seg_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum of x [E] or [E, D] over ``idx`` sorted ascending."""
    if x.dim() == 1:
        return segment_sum_sorted(x[:, None], idx, n)[:, 0]
    return segment_sum_sorted(x, idx, n)


def mp_aggregate(msg: torch.Tensor, dst: torch.Tensor, n: int,
                 op: str = "sum") -> torch.Tensor:
    """Message aggregation onto nodes, the GNN hot path: one kernel launch
    over destination-sorted edges. ``op="max"`` is not ported yet."""
    if op != "sum":
        raise NotImplementedError(f"mp_aggregate op={op!r} {_UNPORTED}")
    return segment_sum_sorted(msg, dst, n)


def degrees(dst: torch.Tensor, n: int) -> torch.Tensor:
    """In-degree [n] float32 of destination-sorted edges."""
    return seg_sum(torch.ones((dst.shape[0],), dtype=torch.float32,
                              device=dst.device), dst, n)


# ---------------------------------------------------------------------------
# GCN (Kipf & Welling) — sym-normalized SpMM via segments
# ---------------------------------------------------------------------------

def gcn_init(cfg: GNNConfig, generator: torch.Generator,
             device: str | torch.device | None = None) -> dict:
    """Float32 fan-in truncated-normal layer weights from ``generator`` (a
    generator on ``device``; ``cuda`` by default)."""
    dev = resolve_device(device)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"w": [dense_init(generator, (dims[i], dims[i + 1]),
                             dtype=torch.float32, device=dev)
                  for i in range(cfg.n_layers)]}


def gcn_forward(cfg: GNNConfig, params: dict, feat: torch.Tensor,
                edge_index: torch.Tensor) -> torch.Tensor:
    """feat [N, F]; edge_index int32 [E, 2] (src, dst) -> logits [N,
    n_classes]. Self-loops added here. Unsorted edges are sorted first;
    pass ``sort_by_dst(edge_index)`` to sort a graph once for many
    forwards."""
    n = feat.shape[0]
    if not is_sorted_by_dst(edge_index):
        edge_index = sort_by_dst(edge_index)
    src = edge_index[:, 0].contiguous()
    dst = edge_index[:, 1].contiguous()
    deg = degrees(dst, n) + 1.0                           # +1 self loop
    inv_sqrt = torch.rsqrt(deg)
    norm = (inv_sqrt[src] * inv_sqrt[dst])[:, None]
    self_norm = (inv_sqrt * inv_sqrt)[:, None]
    x = feat
    last = len(params["w"]) - 1
    for i, w in enumerate(params["w"]):
        x = x @ w
        msg = x[src].mul_(norm)
        agg = mp_aggregate(msg, dst, n) + x * self_norm
        del msg
        x = agg if i == last else torch.relu(agg)
    return x


# ---------------------------------------------------------------------------
# uniform family API
# ---------------------------------------------------------------------------

def gnn_init(cfg: GNNConfig, generator: torch.Generator,
             device: str | torch.device | None = None) -> dict:
    if cfg.model != "gcn":
        raise NotImplementedError(f"GNN model {cfg.model!r} {_UNPORTED}")
    return gcn_init(cfg, generator, device)
