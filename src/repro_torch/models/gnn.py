"""GNN inference and training over destination-sorted edges (port of
``repro/models/gnn.py``): GCN, PNA, EGNN and NequIP, and their loss
:func:`gnn_loss`.

Every sum over edges runs through the ``segment_sum_sorted`` kernel, which
takes edges sorted by destination: :func:`sort_by_dst` sorts a graph once
(stable), and each forward sorts edges it is handed unsorted. PNA's max and
min are ``scatter_reduce`` (:func:`seg_max`), as they are XLA's
``segment_max`` in the reference, not a Pallas kernel.

PNA, EGNN and NequIP compute their messages chunk by chunk: a graph of
more than :data:`EDGE_CHUNK` edges is cut at node boundaries
(:func:`edge_chunks`), so every node's run of edges lies in one chunk, and
each chunk's sums go straight into the rows of its node range. At
ogb_products' size one [E, D] message tensor would not fit the card
(NequIP's l2 messages alone are [61.86M, 576] float32, 142 GB). Below the
cap a forward takes one chunk, the whole graph.

Serving and training share the forwards. Serving (no tensor requiring
grad) writes each chunk's sums in place into its rows of a preallocated
[N, D] tensor. Training (:func:`gnn_loss` under autograd) runs each layer
under a non-reentrant ``torch.utils.checkpoint``, as the reference remats
each layer with ``jax.checkpoint``, and each chunk's message-and-aggregate
under a checkpoint of its own, as the reference remats its fused NequIP
chunks: the backward holds one chunk's edge state at a time, and the
chunks' node rows are joined by ``torch.cat`` (they cover [0, N) in
order). ``segment_sum_sorted``'s gradient gathers the output's gradient by
``dst``; on one device max and min take ``scatter_reduce``'s gradient,
which splits the cotangent evenly among tied elements, as
``jax.ops.segment_max``'s derivative does on one device.

**The mesh routes.** Each forward and :func:`gnn_loss` take ``rules``
(:class:`~repro_torch.models.common.AxisRules`); where ``rules.mesh`` is
set and ``rules.batch`` is not empty they run the reference's
vertex-partitioned schedule (``mp_aggregate``'s ``shard_map`` branch)
on ``torch.distributed``. Every argument arrives as the reference's GNN
cell shards it: the node arrays (feat, labels, label_mask, species,
coords, graph_ids) hold this rank's rows, ``edge_index`` this rank's
block of the edge list (global node ids), ``energy`` and the params are
whole. A rank sorts its block by dst (once a graph), sums its edges
(chunk by chunk, as above) into a full [N, D] partial and
``psum_scatter``s it over the batch axes onto the node shards. GSPMD
gathers the node tensors that ``x[src]`` and ``x[dst]`` read without
being asked; the port ``all_gather``s each one once a layer (GCN's
norms, PNA's and EGNN's features, EGNN's coordinates, NequIP's irreps),
whose backward is ``psum_scatter``. Sums across ranks (the masked NLL and
its count, PNA's mean log-degree, the per-graph energies) are ``psum``s.
The max there is the reference's mesh rule: each rank's max (rows
without an edge at -inf), ``pmax``, empty rows 0, and a backward that
gives **every tie the whole cotangent** (``dmsg = where(m == y[d],
g[d], 0)``, the reference's ``custom_vjp``), not the even split of one
device. Replicated params get each rank's share of their gradient; the
train step sums them over the batch axes
(:func:`repro_torch.runtime.train_loop.make_train_step`).

Names and layouts at the public functions are the JAX module's: features
[N, F], ``edge_index`` int32 [E, 2] (src, dst), species [N] int, coords
[N, 3], params as nested dicts and lists with ``(w, b)`` tuples for MLP
layers. Where the port differs, by design: NequIP's fused, sharded chunk
scan (the reference's ``_nequip_aggregate_fused``) is the chunk loop
above on the rank's block, its chunks' node rows joined into one partial
that is scattered once a layer (see :func:`nequip_forward`); GCN computes
the symmetric edge norms once for all layers (the JAX module recomputes
them per layer, with the same operations) and scales the gathered
messages in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..device import resolve_device
from ..kernels.segment_mp import segment_sum_sorted
from ..launch import collectives as col
from .common import dense_init

# Edges of one chunk. NequIP (C = 32) is the widest model: a chunk's
# gathered sources (l0, l1, l2: 416 float32 an edge), radial weights (192),
# its three message tensors (64 + 288 + 576) and the l2 path's
# temporaries while the last is concatenated (~580) hold about 2,100
# float32, 8.4 KB an edge, so 2^19 edges take about 4.4 GB (PNA's and
# EGNN's about 3 and 2.5 KB an edge). A node whose in-degree passes the cap
# (0.68M edges at ogb_products' hub) is a chunk of its own.
EDGE_CHUNK = 1 << 19


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


# ---------------------------------------------------------------------------
# sorted edges, chunks and segment helpers
# ---------------------------------------------------------------------------

def sort_by_dst(edge_index: torch.Tensor) -> torch.Tensor:
    """edge_index [E, 2] (src, dst) -> the same edges ordered by dst, ties
    in their original order: the layout the segment kernel takes. Done once
    per graph."""
    order = torch.sort(edge_index[:, 1], stable=True).indices
    return edge_index[order]


def is_sorted_by_dst(edge_index: torch.Tensor) -> bool:
    """Whether dst is ascending (one device reduction, one host sync). On
    ``meta`` (the dry run) there is no data to read, and the edges are
    taken as sorted, as the data pipeline hands them over (``sort_by_dst``
    once a graph; the sampler's edges come sorted)."""
    if edge_index.device.type == "meta":
        return True
    dst = edge_index[:, 1]
    return bool((dst[1:] >= dst[:-1]).all())


def _src_dst(edge_index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous (src, dst) of the edges sorted by dst (sorted here when
    they come unsorted)."""
    if not is_sorted_by_dst(edge_index):
        edge_index = sort_by_dst(edge_index)
    return edge_index[:, 0].contiguous(), edge_index[:, 1].contiguous()


class EdgeChunk(NamedTuple):
    e0: int        # edges [e0, e1) of the sorted graph ...
    e1: int
    lo: int        # ... whose destinations all lie in nodes [lo, hi)
    hi: int


def edge_chunks(dst: torch.Tensor, n: int,
                cap: int | None = None) -> list[EdgeChunk]:
    """Cut destination-sorted ``dst`` [E] (all in [0, n)) into chunks of at
    most ``cap`` edges (:data:`EDGE_CHUNK` by default) at node boundaries,
    each edge and each node in exactly one chunk, the node ranges
    contiguous from 0 to ``n``. A node whose run passes the cap is a chunk
    of its own; runs are never split. One chunk, the whole graph, when E
    <= cap; else two host reads per chunk (a run start by
    ``torch.searchsorted``).

    On ``meta`` (the dry run) the runs cannot be read: [0, E) is cut into
    ceil(E / cap) equal spans and [0, n) into as many proportional node
    ranges (:func:`uniform_chunks`)."""
    cap = EDGE_CHUNK if cap is None else int(cap)
    if cap <= 0:
        raise ValueError(f"cap must be positive, got {cap}")
    E = int(dst.shape[0])
    if dst.device.type == "meta":
        return uniform_chunks(E, n, cap)
    chunks: list[EdgeChunk] = []
    e0 = lo = 0
    while E - e0 > cap:
        v = int(dst[e0 + cap])            # the node of the first edge past
        e1 = int(torch.searchsorted(dst, v))   # the cap starts a chunk ...
        hi = v
        if e1 == e0:                      # ... unless its run starts here:
            e1 = int(torch.searchsorted(dst, v, right=True))   # on its own
            hi = v + 1
        chunks.append(EdgeChunk(e0, e1, lo, hi))
        e0, lo = e1, hi
    if lo < n or not chunks:
        chunks.append(EdgeChunk(e0, E, lo, n))
    return chunks


def uniform_chunks(E: int, n: int, cap: int) -> list[EdgeChunk]:
    """The dry run's chunk plan: ceil(E / cap) spans of [0, E) as equal as
    integers allow, each with the proportional share of [0, n)."""
    k = max(1, -(-E // cap))
    return [EdgeChunk(i * E // k, (i + 1) * E // k, i * n // k,
                      (i + 1) * n // k) for i in range(k)]


class _Chunk(NamedTuple):
    src: torch.Tensor      # src[e0:e1]
    dst: torch.Tensor      # dst[e0:e1]
    local: torch.Tensor    # dst[e0:e1] - lo: a fresh tensor, on 16 bytes
    lo: int
    hi: int


def _chunks(src: torch.Tensor, dst: torch.Tensor, n: int) -> list[_Chunk]:
    """The forward's chunks with their index slices. A lone chunk keeps
    ``dst`` itself as its local destinations."""
    plan = edge_chunks(dst, n)
    if len(plan) == 1:
        return [_Chunk(src, dst, dst, 0, n)]
    return [_Chunk(src[c.e0:c.e1], dst[c.e0:c.e1], dst[c.e0:c.e1] - c.lo,
                   c.lo, c.hi) for c in plan]


def _training(*trees) -> bool:
    """Whether a forward takes a gradient: grad mode is on and a tensor of
    ``trees`` (params, inputs) requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree.leaves(trees))


def _remat(train: bool, fn, *args):
    """``fn(*args)``, under a non-reentrant checkpoint when training (its
    activations recomputed in the backward)."""
    if train:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _join(rows: list[torch.Tensor]) -> torch.Tensor:
    """The chunks' node rows, in chunk order, as one [N, D] tensor."""
    return rows[0] if len(rows) == 1 else torch.cat(rows)


def _chunked(body, chunks: list[_Chunk], n: int, widths, like: torch.Tensor,
             train: bool) -> list[torch.Tensor]:
    """A chunk loop's node sums, one [n, D] tensor a width of ``widths``.
    ``body(i, outs)`` aggregates chunk ``i``'s edges into its node rows
    [hi - lo, D], a tensor a width, written into ``outs`` (row slices)
    where given. Serving writes every chunk in place into [n, D] tensors
    like ``like``; training runs each chunk under a checkpoint of its own
    and joins the rows (:func:`_join`); so the tensors ``body`` reads
    from its closure must not be rebound before the backward."""
    if not train:
        accs = [like.new_empty((n, w)) for w in widths]
        for i, ch in enumerate(chunks):
            body(i, [a[ch.lo:ch.hi] for a in accs])
        return accs
    rows = [checkpoint(body, i, None, use_reentrant=False)
            for i in range(len(chunks))]
    return [_join(list(r)) for r in zip(*rows)]


def _sum(msg: torch.Tensor, ch: _Chunk,
         out: torch.Tensor | None) -> torch.Tensor:
    """A chunk's messages summed into its node rows [hi - lo, D] (into
    ``out`` in place where given; the kernel zeroes exactly those rows
    first)."""
    return segment_sum_sorted(msg, ch.local, ch.hi - ch.lo, out=out)


def seg_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum of x [E] or [E, D] over ``idx`` sorted ascending."""
    if x.dim() == 1:
        return segment_sum_sorted(x[:, None], idx, n)[:, 0]
    return segment_sum_sorted(x, idx, n)


def seg_max(x: torch.Tensor, idx: torch.Tensor, n: int,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Segment max of x [E, D] over ``idx`` [E] (any order), empty segments
    0 (not -inf); ``out`` [n, D] receives it in place. Under autograd it
    works out of place (``out`` raises ``ValueError``), and its gradient
    splits each row's cotangent evenly among the elements tied at the
    max, as ``jax.ops.segment_max``'s does. That route starts the rows at
    -inf and zeroes the empty ones after, as the reference does: the
    backward of ``scatter_reduce(..., include_self=False)`` counts the
    untouched start value among the ties, so a max of exactly 0 over
    zero rows would get half its cotangent."""
    index = idx.long()[:, None].expand_as(x)
    if torch.is_grad_enabled() and x.requires_grad:
        if out is not None:
            raise ValueError("seg_max: out= writes in place and takes no "
                             "gradient")
        raw = x.new_full((n, x.shape[1]), -math.inf).scatter_reduce(
            0, index, x, "amax")
        has = torch.zeros((n, 1), dtype=torch.bool,
                          device=x.device).index_fill_(0, idx.long(), True)
        return torch.where(has, raw, 0.0)
    out = x.new_zeros((n, x.shape[1])) if out is None else out.zero_()
    return out.scatter_reduce_(0, index, x, "amax", include_self=False)


def seg_min(x: torch.Tensor, idx: torch.Tensor, n: int,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """-seg_max(-x), as the reference takes it (negated in place when no
    gradient is taken)."""
    y = seg_max(-x, idx, n, out)
    return y.neg() if y.requires_grad else y.neg_()


def seg_mean(x: torch.Tensor, idx: torch.Tensor, n: int,
             eps: float = 1e-9) -> torch.Tensor:
    """Segment mean of x [E, D] over ``idx`` sorted ascending."""
    cnt = seg_sum(torch.ones((x.shape[0], 1), dtype=x.dtype,
                             device=x.device), idx, n)
    return seg_sum(x, idx, n) / (cnt + eps)


# ---------------------------------------------------------------------------
# the mesh routes (the reference's shard_map branch of mp_aggregate)
# ---------------------------------------------------------------------------

def _on_mesh(rules) -> bool:
    """Whether ``rules`` takes the mesh routes: a mesh and batch axes, the
    reference's condition."""
    return rules is not None and rules.mesh is not None and bool(rules.batch)


def _shards(rules) -> int:
    """The node shards: the batch axes' rank count, 1 off the mesh."""
    return col.axis_size(rules.mesh, rules.batch) if _on_mesh(rules) else 1


def _nodes(n_local: int, rules) -> int:
    """The graph's node count from a rank's rows."""
    return n_local * _shards(rules)


def _gather_nodes(x: torch.Tensor, rules) -> torch.Tensor:
    """A node tensor whole [N, ...] from each rank's rows (backward:
    ``psum_scatter``); ``x`` itself off the mesh."""
    if not _on_mesh(rules):
        return x
    return col.all_gather(x, rules.mesh, rules.batch)


def _scatter_nodes(partial: torch.Tensor, rules) -> torch.Tensor:
    """A rank's [N, D] partial summed over the batch axes, this rank's
    rows kept (backward: ``all_gather``); ``partial`` itself off the
    mesh."""
    if not _on_mesh(rules):
        return partial
    return col.psum_scatter(partial, rules.mesh, rules.batch)


def _psum(x: torch.Tensor, rules) -> torch.Tensor:
    """``x`` summed over the batch axes (the cotangent goes back to each
    rank unchanged); ``x`` itself off the mesh."""
    return col.psum(x, rules.mesh, rules.batch) if _on_mesh(rules) else x


def _my_rows(full: torch.Tensor, rules) -> torch.Tensor:
    """This rank's rows of a node tensor [N, ...]."""
    nl = full.shape[0] // _shards(rules)
    i = col.axis_index(rules.mesh, rules.batch)
    return full[i * nl:(i + 1) * nl]


class _TieMax(torch.autograd.Function):
    """The max [rows, D] of msg [E, D] over dst [E] in [0, rows), rows
    without an edge at -inf. Backward: each element tied at its row's max
    gets the whole cotangent."""

    @staticmethod
    def forward(ctx, msg, dst, rows):
        index = dst.long()[:, None].expand_as(msg)
        raw = msg.new_full((rows, msg.shape[1]), -math.inf)
        raw.scatter_reduce_(0, index, msg, "amax")
        ctx.save_for_backward(msg, dst, raw)
        return raw

    @staticmethod
    def backward(ctx, g):
        msg, dst, raw = ctx.saved_tensors
        d = dst.long()
        return torch.where(msg == raw[d], g[d], 0.0), None, None


class _MeshMax(torch.autograd.Function):
    """A rank's maxima [N, D] (-inf where it has no edge) combined over the
    batch axes by ``pmax``, rows of no edge on any rank (``has`` false)
    0, this rank's rows kept. Backward: the output and its cotangent
    all-gathered to [N, D], the whole cotangent of a row to every rank
    whose max equals it; with :class:`_TieMax` below, every tie of every
    rank gets it, as the reference's mesh ``custom_vjp`` gives it."""

    @staticmethod
    def forward(ctx, raw, has, rules):
        full = col.pmax(raw, rules.mesh, rules.batch)
        y = torch.where(has, _my_rows(full, rules), 0.0)
        ctx.rules = rules
        ctx.save_for_backward(raw, y)
        return y

    @staticmethod
    def backward(ctx, g):
        raw, y = ctx.saved_tensors
        r = ctx.rules
        yf = col.all_gather(y, r.mesh, r.batch)
        gf = col.all_gather(g.contiguous(), r.mesh, r.batch)
        return torch.where(raw == yf, gf, 0.0), None, None


def _raw_max(msg: torch.Tensor, ch: "_Chunk",
             out: torch.Tensor | None) -> torch.Tensor:
    """A chunk's maxima into its node rows [hi - lo, D], -inf where a row
    has no edge (into ``out`` in place where given)."""
    if out is None:
        return _TieMax.apply(msg, ch.local, ch.hi - ch.lo)
    index = ch.local.long()[:, None].expand_as(msg)
    return out.fill_(-math.inf).scatter_reduce_(0, index, msg, "amax")


def mp_aggregate(msg: torch.Tensor, dst: torch.Tensor, n: int,
                 rules=None, op: str = "sum") -> torch.Tensor:
    """Message aggregation onto nodes, the GNN hot path.

    Off the mesh: one kernel launch over destination-sorted edges for
    ``op="sum"``; ``op="max"`` is :func:`seg_max` (empty rows 0, a tie's
    cotangent split evenly). On the mesh (``rules.mesh`` set, batch axes
    not empty; the reference's vertex-partitioned ``shard_map`` branch):
    ``msg`` [E_l, D] and ``dst`` [E_l] are this rank's edge block, dst
    sorted and in [0, n); the result is this rank's [n / nsh, D] node
    rows. The sum runs the ``segment_sum_sorted`` kernel into a full
    [n, D] partial, then ``psum_scatter`` over the batch axes. The max is
    the rank's max, ``pmax``, rows of no edge 0 (``has`` from a ``psum`` of
    the counts), and a backward giving each tie the whole cotangent.
    Raises ``ValueError`` where n is not divisible by the node shards."""
    if op not in ("sum", "max"):
        raise ValueError(f"mp_aggregate op must be 'sum' or 'max', "
                         f"got {op!r}")
    if not _on_mesh(rules):
        if op == "sum":
            return segment_sum_sorted(msg, dst, n)
        return seg_max(msg, dst, n)
    nsh = _shards(rules)
    if n % nsh:
        raise ValueError(f"node dim {n} not divisible by {nsh}")
    if op == "sum":
        return _scatter_nodes(segment_sum_sorted(msg, dst, n), rules)
    cnt = segment_sum_sorted(msg.new_ones((msg.shape[0], 1)), dst, n)
    has = _my_rows(_psum(cnt, rules), rules) > 0
    return _MeshMax.apply(_TieMax.apply(msg, dst, n), has, rules)


def degrees(dst: torch.Tensor, n: int, rules=None) -> torch.Tensor:
    """In-degree [n] float32 of destination-sorted edges; on the mesh,
    this rank's rows [n / nsh] of the in-degree of every rank's edges."""
    if _on_mesh(rules):
        return mp_aggregate(torch.ones((dst.shape[0], 1), dtype=torch.float32,
                                       device=dst.device), dst, n, rules)[:, 0]
    return seg_sum(torch.ones((dst.shape[0],), dtype=torch.float32,
                              device=dst.device), dst, n)


def _mlp(params: list, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` a layer, silu between layers, none after the last."""
    for i, (w, b) in enumerate(params):
        x = torch.addmm(b, x, w)
        if i < len(params) - 1:
            x = F.silu(x, inplace=True)
    return x


def _mlp_init(generator: torch.Generator, dims: list[int],
              dev: torch.device) -> list:
    return [(dense_init(generator, (dims[i], dims[i + 1]),
                        dtype=torch.float32, device=dev),
             torch.zeros((dims[i + 1],), dtype=torch.float32, device=dev))
            for i in range(len(dims) - 1)]


def _dense(generator: torch.Generator, shape: tuple[int, int],
           dev: torch.device) -> torch.Tensor:
    return dense_init(generator, shape, dtype=torch.float32, device=dev)


def _rel(pos: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pos[a] - pos[b]: the edge vectors of EGNN (dst - src) and NequIP
    (src - dst)."""
    return pos[a] - pos[b]


def _graph_sum(e_atom: torch.Tensor, graph_ids: torch.Tensor,
               n_graphs: int) -> torch.Tensor:
    """Per-graph sum of atom energies [N] over ``graph_ids`` [N] int32, one
    kernel launch at D = 1. ``molecule_batch`` emits the ids ascending
    (``np.repeat``), as the kernel takes them; unsorted ids are sorted here
    first (stable). On ``meta`` they are taken as sorted."""
    if graph_ids.device.type != "meta" and not bool(
            (graph_ids[1:] >= graph_ids[:-1]).all()):
        order = torch.sort(graph_ids, stable=True).indices
        graph_ids, e_atom = graph_ids[order], e_atom[order]
    return seg_sum(e_atom.contiguous(), graph_ids, n_graphs)


# ---------------------------------------------------------------------------
# GCN (Kipf & Welling) — sym-normalized SpMM via segments
# ---------------------------------------------------------------------------

def gcn_init(cfg: GNNConfig, generator: torch.Generator,
             device: str | torch.device | None = None) -> dict:
    """Float32 fan-in truncated-normal layer weights from ``generator`` (a
    generator on ``device``; ``cuda`` by default)."""
    dev = resolve_device(device)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"w": [_dense(generator, (dims[i], dims[i + 1]), dev)
                  for i in range(cfg.n_layers)]}


def gcn_forward(cfg: GNNConfig, params: dict, feat: torch.Tensor,
                edge_index: torch.Tensor, rules=None) -> torch.Tensor:
    """feat [N, F]; edge_index int32 [E, 2] (src, dst) -> logits [N,
    n_classes]. Self-loops added here. Unsorted edges are sorted first;
    pass ``sort_by_dst(edge_index)`` to sort a graph once for many
    forwards. On the mesh (``rules``), the rank's rows and edge block
    (module docstring): the norms and each layer's ``x @ w`` are
    all-gathered for the gather by edge."""
    n = _nodes(feat.shape[0], rules)
    src, dst = _src_dst(edge_index)
    deg = degrees(dst, n, rules) + 1.0                    # +1 self loop
    inv_sqrt = torch.rsqrt(deg)
    inv_all = _gather_nodes(inv_sqrt, rules)
    norm = (inv_all[src] * inv_all[dst])[:, None]
    self_norm = (inv_sqrt * inv_sqrt)[:, None]

    def layer(x, w, last):
        x = x @ w
        msg = _gather_nodes(x, rules)[src].mul_(norm)
        agg = mp_aggregate(msg, dst, n, rules) + x * self_norm
        del msg
        return agg if last else torch.relu(agg)

    train = _training(params, feat)
    x = feat
    for i, w in enumerate(params["w"]):
        x = _remat(train, layer, x, w, i == len(params["w"]) - 1)
    return x


# ---------------------------------------------------------------------------
# PNA (Corso et al.) — multi-aggregator + degree scalers
# ---------------------------------------------------------------------------

def pna_init(cfg: GNNConfig, generator: torch.Generator,
             device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    h = cfg.d_hidden
    n_agg = len(cfg.aggregators) * len(cfg.scalers)
    return {
        "encode": _mlp_init(generator, [cfg.d_feat, h], dev),
        "layers": [{"msg": _mlp_init(generator, [2 * h, h, h], dev),
                    "post": _mlp_init(generator, [n_agg * h + h, h, h], dev)}
                   for _ in range(cfg.n_layers)],
        "decode": _mlp_init(generator, [h, h, cfg.n_classes], dev),
    }


def _scaled_concat(aggs: list, scales: list,
                   x: torch.Tensor) -> torch.Tensor:
    """PNA's post-MLP input [N, len(scales) * len(aggs) * H + H]: each
    aggregate times each scaler, then ``x``, each written into its columns
    of one buffer (autograd follows the slice writes)."""
    H = x.shape[1]
    h = x.new_empty((x.shape[0], (len(scales) * len(aggs) + 1) * H))
    k = 0
    for sc in scales:
        for a in aggs:
            h[:, k:k + H] = a * sc
            k += H
    h[:, k:] = x
    return h


def pna_forward(cfg: GNNConfig, params: dict, feat: torch.Tensor,
                edge_index: torch.Tensor, rules=None) -> torch.Tensor:
    """feat [N, F]; edge_index int32 [E, 2] (src, dst) -> logits [N,
    n_classes]. Per chunk one message MLP on ``[x[dst], x[src]]``; its sum
    and its square's sum go through the kernel, max and min through
    :func:`seg_max`, and the chunk's messages are freed. On the mesh
    (``rules``), the rank's rows and edge block: ``x`` all-gathered once a
    layer, the sums scattered onto the node shards, max and min by the
    mesh rule (:class:`_MeshMax`), the mean log-degree over every rank."""
    for a in cfg.aggregators:
        if a not in ("mean", "max", "min", "std"):
            raise ValueError(f"unknown PNA aggregator {a!r}")
    mesh = _on_mesh(rules)
    n = _nodes(feat.shape[0], rules)
    src, dst = _src_dst(edge_index)
    chunks = _chunks(src, dst, n)
    cnt = degrees(dst, n, rules)[:, None]
    deg = cnt[:, 0]
    safe_cnt = cnt.clamp(min=1.0)
    has = cnt > 0
    # PNA degree scalers, delta = mean log(deg+1) over the batch graph
    logd = torch.log(deg + 1.0)
    delta = (_psum(logd.sum(), rules) / n if mesh else logd.mean()) + 1e-9
    scaler_map = {
        "identity": torch.ones_like(deg),
        "amplification": logd / delta,
        # deg-0 rows aggregate to zero anyway; clamp keeps the scaler finite
        "attenuation": delta / logd.clamp(min=math.log(2.0)),
    }
    scales = [scaler_map[sc][:, None] for sc in cfg.scalers]
    parts = [a for a in cfg.aggregators if a != "mean"]

    def layer(x, lp):
        xa = _gather_nodes(x, rules)

        def body(i, outs):
            ch = chunks[i]
            outs = outs or [None] * (1 + len(parts))
            m = _mlp(lp["msg"], torch.cat([xa[ch.dst], xa[ch.src]], dim=-1))
            rows = [_sum(m, ch, outs[0])]
            for a, out in zip(parts, outs[1:]):
                if a == "std":
                    rows.append(_sum(m * m, ch, out))
                elif mesh:    # the rank's max of m, or of -m for the min
                    rows.append(_raw_max(m if a == "max" else -m, ch, out))
                else:
                    agg = seg_max if a == "max" else seg_min
                    rows.append(agg(m, ch.local, ch.hi - ch.lo, out=out))
            return rows

        total, *sums = _chunked(body, chunks, n, [x.shape[1]] * (1 + len(
            parts)), x, train)
        total = _scatter_nodes(total, rules)
        got = {}
        for a, part in zip(parts, sums):
            if a == "std" or not mesh:
                got[a] = _scatter_nodes(part, rules)
            else:             # PNA's min is -max(-m), as the reference's
                y = _MeshMax.apply(part, has, rules)
                got[a] = y if a == "max" else -y
        del sums
        mean = total / safe_cnt
        del total
        aggs = []
        for a in cfg.aggregators:
            if a == "mean":
                aggs.append(mean)
            elif a == "std":
                sq = got["std"] / safe_cnt
                # maximum, not clamp: its gradient at 0 (a node of one
                # edge) is the reference's jnp.maximum's
                aggs.append(torch.sqrt(torch.maximum(sq - mean * mean,
                                                     sq.new_zeros(()))
                                       + 1e-9))
            else:
                aggs.append(got[a])
        del got, mean
        h = _scaled_concat(aggs, scales, x)
        del aggs
        return x + _mlp(lp["post"], h)

    train = _training(params, feat)
    x = _mlp(params["encode"], feat)
    for lp in params["layers"]:
        x = _remat(train, layer, x, lp)
    return _mlp(params["decode"], x)


# ---------------------------------------------------------------------------
# EGNN (Satorras et al.) — E(n)-equivariant, scalar-distance messages
# ---------------------------------------------------------------------------

def egnn_init(cfg: GNNConfig, generator: torch.Generator,
              device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    h = cfg.d_hidden
    return {
        "embed": _dense(generator, (cfg.n_species, h), dev),
        "layers": [{"phi_e": _mlp_init(generator, [2 * h + 1, h, h], dev),
                    "phi_x": _mlp_init(generator, [h, h, 1], dev),
                    "phi_h": _mlp_init(generator, [2 * h, h, h], dev)}
                   for _ in range(cfg.n_layers)],
        "decode": _mlp_init(generator, [h, h, 1], dev),
    }


def egnn_forward(cfg: GNNConfig, params: dict, species: torch.Tensor,
                 coords: torch.Tensor, edge_index: torch.Tensor, rules=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """species [N] int, coords [N, 3]. Returns (h [N, H], coords' [N,
    3]). On the mesh (``rules``), the rank's rows and edge block: ``h``
    and the coordinates, which change every layer, all-gathered once a
    layer."""
    n = _nodes(coords.shape[0], rules)
    src, dst = _src_dst(edge_index)
    chunks = _chunks(src, dst, n)
    safe_cnt = degrees(dst, n, rules)[:, None].clamp(min=1.0)

    def layer(h, x, lp):
        ha, xa = _gather_nodes(h, rules), _gather_nodes(x, rules)

        def body(i, outs):
            ch = chunks[i]
            outs = outs or [None, None]
            rel = _rel(xa, ch.dst, ch.src)
            d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
            m = _mlp(lp["phi_e"], torch.cat([ha[ch.dst], ha[ch.src], d2],
                                            dim=-1))
            # coordinate update, normalized for stability (EGNN §3.1
            # variant: unit-ish direction + bounded coefficient keeps |x|
            # from blowing up)
            coef = torch.tanh(_mlp(lp["phi_x"], m))
            return [_sum(rel / (torch.sqrt(d2) + 1.0) * coef, ch, outs[0]),
                    _sum(m, ch, outs[1])]

        upd, magg = (_scatter_nodes(a, rules) for a in _chunked(
            body, chunks, n, (3, h.shape[1]), h, train))
        # ha and xa are not rebound: a chunk's checkpoint reads them again
        return (h + _mlp(lp["phi_h"], torch.cat([h, magg], dim=-1)),
                x + upd / safe_cnt)

    train = _training(params, coords)
    h = params["embed"][species]
    x = coords
    for lp in params["layers"]:
        h, x = _remat(train, layer, h, x, lp)
    return h, x


def egnn_energy(cfg: GNNConfig, params: dict, species, coords, edge_index,
                graph_ids, n_graphs: int, rules=None) -> torch.Tensor:
    """Energies [n_graphs]: the decoded atom energies summed per graph (on
    the mesh, each rank's rows summed, then a ``psum``)."""
    h, _ = egnn_forward(cfg, params, species, coords, edge_index, rules)
    e_atom = _mlp(params["decode"], h)[:, 0]
    return _psum(_graph_sum(e_atom, graph_ids, n_graphs), rules)


# ---------------------------------------------------------------------------
# NequIP (Batzner et al.) — E(3)-equivariant tensor products, l_max = 2
# Cartesian irrep basis: l0 [., C], l1 [., C, 3], l2 [., C, 3, 3] (sym-tr.)
# ---------------------------------------------------------------------------

def _sym_traceless(M: torch.Tensor) -> torch.Tensor:
    Ms = 0.5 * (M + M.transpose(-1, -2))
    tr = torch.diagonal(Ms, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    return Ms - tr * eye / 3.0


def _bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """NequIP radial basis: sin(n pi r / rc) / r with polynomial cutoff."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rc = cutoff
    rs = torch.clamp(r, 1e-5, rc)
    basis = math.sqrt(2.0 / rc) * torch.sin(n * math.pi * rs[..., None] / rc) \
        / rs[..., None]
    u = torch.clamp(r / rc, 0.0, 1.0)
    env = 1.0 - 10.0 * u**3 + 15.0 * u**4 - 6.0 * u**5   # p=3 polynomial
    return basis * env[..., None]


def nequip_init(cfg: GNNConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    C = cfg.d_hidden
    return {
        "embed": _dense(generator, (cfg.n_species, C), dev),
        "layers": [{
            # radial MLP -> per-path, per-channel weights (6 paths)
            "radial": _mlp_init(generator, [cfg.n_rbf, C, 6 * C], dev),
            # channel mixers per output l
            "mix0": _dense(generator, (2 * C, C), dev),
            "mix1": _dense(generator, (3 * C, C), dev),
            "mix2": _dense(generator, (2 * C, C), dev),
            # gates: scalars produced from l0 to gate l1/l2
            "gate": _mlp_init(generator, [C, 2 * C], dev),
            "self0": _dense(generator, (C, C), dev),
            "self1": _dense(generator, (C, C), dev),
            "self2": _dense(generator, (C, C), dev),
        } for _ in range(cfg.n_layers)],
        "decode": _mlp_init(generator, [C, C, 1], dev),
    }


def _nequip_geometry(cfg: GNNConfig, coords: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(rbf [E, n_rbf], Y1 [E, 3], Y2 [E, 3, 3]) of the edges (src, dst):
    the radial basis and the spherical harmonics in the Cartesian basis."""
    rel = _rel(coords, src, dst)                       # [E, 3]
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    rhat = rel / r[:, None]
    Y2 = _sym_traceless(rhat[:, :, None] * rhat[:, None, :])
    return _bessel_rbf(r, cfg.n_rbf, cfg.cutoff), rhat, Y2


def _nequip_messages(cfg: GNNConfig, radial_mlp, rbf, Y1, Y2, s0, s1, s2,
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tensor-product messages for one edge set (a chunk or the graph).

    CG contractions in Cartesian form:
      p0: l0 x Y0 -> l0        p1: l0 x Y1 -> l1     p2: l0 x Y2 -> l2
      p3: l1 . Y1 -> l0        p4: l1 x Y1 -> l1 (cross)
      p5: l2 @ Y1 -> l1        (+ l1 (x) Y1 -> l2 sym-traceless outer)
    Returns flattened (m0 [E,2C], m1 [E,3C*3], m2 [E,2C*9]), each built
    as soon as its parts exist, so the parts are freed early.
    """
    C = cfg.d_hidden
    E = rbf.shape[0]
    W = _mlp(radial_mlp, rbf).reshape(-1, 6, C)        # [E, 6 paths, C]
    m0 = torch.cat([W[:, 0] * s0,
                    W[:, 3] * torch.einsum("eci,ei->ec", s1, Y1)], -1)
    m1 = torch.cat([
        W[:, 1][..., None] * (s0[..., None] * Y1[:, None, :]),
        W[:, 4][..., None] * torch.linalg.cross(s1, Y1[:, None, :], dim=-1),
        W[:, 5][..., None] * torch.einsum("ecij,ej->eci", s2, Y1),
    ], 1).reshape(E, -1)
    m2 = torch.cat([
        W[:, 2][..., None, None] * (s0[..., None, None] * Y2[:, None, :, :]),
        # W[:, 3] again: the radial channel is shared with p3
        W[:, 3][..., None, None]
        * _sym_traceless(s1[..., :, None] * Y1[:, None, None, :]),
    ], 1).reshape(E, -1)
    return m0, m1, m2


def nequip_forward(cfg: GNNConfig, params: dict, species: torch.Tensor,
                   coords: torch.Tensor, edge_index: torch.Tensor,
                   rules=None) -> dict:
    """Returns final irrep features {l0:[N,C], l1:[N,C,3], l2:[N,C,3,3]}.
    The edge geometry is computed once a chunk, the messages once a chunk
    and layer.

    On the mesh (``rules``; the reference's ``_nequip_aggregate_fused``):
    the coordinates are all-gathered once, h0, h1 and h2 once a layer; the
    rank's dst-sorted edges run chunk by chunk, each chunk's
    message-and-aggregate under a checkpoint of its own (training), into
    its node rows of one [N, 2C + 9C + 18C] partial, which is
    ``psum_scatter``ed onto the node shards once a layer. The reference
    scatters each of its 8 chunks' full [N, .] partial instead: the same
    sum in another order. At ogb_products' size (N = 2,449,029, C = 32:
    64 + 288 + 576 float32 a node) a partial is 9.1 GB; the reference's
    schedule holds one such partial a chunk and reduce-scatters each, the
    port holds one a layer (18.2 GB for the moment the training route's
    ``torch.cat`` joins its chunks' rows) and moves 1/k of the bytes for k
    chunks, which matters since a rank's block past 2^19 edges takes as
    many chunks as :func:`edge_chunks` cuts (119 for the whole graph)."""
    n = _nodes(coords.shape[0], rules)
    C = cfg.d_hidden
    src, dst = _src_dst(edge_index)
    chunks = _chunks(src, dst, n)
    coords_all = _gather_nodes(coords, rules)
    geometry = [_nequip_geometry(cfg, coords_all, ch.src, ch.dst)
                for ch in chunks]

    def layer(h0, h1, h2, lp):
        h0a, h1a, h2a = (_gather_nodes(h, rules) for h in (h0, h1, h2))

        def body(i, outs):
            ch = chunks[i]
            outs = outs or [None] * 3
            m0, m1, m2 = _nequip_messages(cfg, lp["radial"], *geometry[i],
                                          h0a[ch.src], h1a[ch.src],
                                          h2a[ch.src])
            return [_sum(m0, ch, outs[0]), _sum(m1, ch, outs[1]),
                    _sum(m2, ch, outs[2])]

        a0, a1, a2 = (_scatter_nodes(a, rules) for a in _chunked(
            body, chunks, n, (2 * C, 9 * C, 18 * C), h0, train))
        nl = h0.shape[0]

        # channel mixing + self-interaction
        n0 = a0 @ lp["mix0"] + h0 @ lp["self0"]
        n1 = torch.einsum("nkx,kc->ncx", a1.reshape(nl, 3 * C, 3),
                          lp["mix1"]) \
            + torch.einsum("ncx,cd->ndx", h1, lp["self1"])
        n2 = torch.einsum("nkxy,kc->ncxy", a2.reshape(nl, 2 * C, 3, 3),
                          lp["mix2"]) \
            + torch.einsum("ncxy,cd->ndxy", h2, lp["self2"])
        del a0, a1, a2

        # gated nonlinearity: scalars via silu; l>0 gated by sigmoids of l0
        g1, g2 = torch.sigmoid(_mlp(lp["gate"], n0)).chunk(2, dim=-1)
        return (h0 + F.silu(n0), h1 + n1 * g1[..., None],
                h2 + n2 * g2[..., None, None])

    train = _training(params, coords)
    h0 = params["embed"][species]                      # [N, C]
    h1 = coords.new_zeros((h0.shape[0], C, 3))
    h2 = coords.new_zeros((h0.shape[0], C, 3, 3))
    for lp in params["layers"]:
        h0, h1, h2 = _remat(train, layer, h0, h1, h2, lp)
    return {"l0": h0, "l1": h1, "l2": h2}


def nequip_energy(cfg: GNNConfig, params: dict, species, coords, edge_index,
                  graph_ids, n_graphs: int, rules=None) -> torch.Tensor:
    """Energies [n_graphs]: the decoded l0 atom energies summed per
    graph (on the mesh, each rank's rows summed, then a ``psum``)."""
    feats = nequip_forward(cfg, params, species, coords, edge_index, rules)
    e_atom = _mlp(params["decode"], feats["l0"])[:, 0]
    return _psum(_graph_sum(e_atom, graph_ids, n_graphs), rules)


# ---------------------------------------------------------------------------
# uniform family API
# ---------------------------------------------------------------------------

_INIT = {"gcn": gcn_init, "pna": pna_init, "egnn": egnn_init,
         "nequip": nequip_init}


def gnn_init(cfg: GNNConfig, generator: torch.Generator,
             device: str | torch.device | None = None) -> dict:
    """Float32 params of ``cfg.model`` from ``generator`` on ``device``
    (``cuda`` by default)."""
    if cfg.model not in _INIT:
        raise ValueError(f"unknown GNN model {cfg.model!r}; "
                         f"one of {sorted(_INIT)}")
    return _INIT[cfg.model](cfg, generator, device)


def gnn_loss(cfg: GNNConfig, params: dict, batch: dict, rules=None
             ) -> tuple[torch.Tensor, dict]:
    """The family's loss, the reference's batch keys.

    GCN and PNA: feat [N, F], edge_index [E, 2], labels [N] int,
    label_mask [N] float -> the masked mean NLL of the float32 logits,
    ``nll.sum() / max(label_mask.sum(), 1)``, aux ``{"nll": loss}``.
    EGNN and NequIP: species [N], coords [N, 3], edge_index, graph_ids
    [N], energy [G] -> the mean squared error of the per-graph energies,
    aux ``{"mse": loss}``.

    On the mesh (``rules``), ``batch`` holds what the reference's GNN cell
    gives a rank (module docstring); the NLL's sum and the mask's count
    are ``psum``med over the batch axes, so every rank returns the whole
    loss, and each replicated param's gradient is this rank's share.

    Where the port differs: a label outside ``[0, n_classes)`` makes
    ``F.cross_entropy`` raise ``IndexError`` (on the CPU; a device-side
    assert on the card), where the reference's ``take_along_axis`` gives a
    NaN loss."""
    if cfg.model in ("gcn", "pna"):
        fwd = gcn_forward if cfg.model == "gcn" else pna_forward
        logits = fwd(cfg, params, batch["feat"], batch["edge_index"],
                     rules).float()
        nll = F.cross_entropy(logits, batch["labels"].long(),
                              reduction="none") * batch["label_mask"]
        loss = _psum(nll.sum(), rules) / _psum(
            batch["label_mask"].sum(), rules).clamp(min=1.0)
        return loss, {"nll": loss}
    energy_fn = egnn_energy if cfg.model == "egnn" else nequip_energy
    pred = energy_fn(cfg, params, batch["species"], batch["coords"],
                     batch["edge_index"], batch["graph_ids"],
                     batch["energy"].shape[0], rules)
    loss = torch.mean((pred - batch["energy"]) ** 2)
    return loss, {"mse": loss}
