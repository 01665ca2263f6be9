"""Wide & Deep scoring and retrieval (port of ``repro/models/recsys.py``).

The lookup is the FBGEMM-style *unified table* of the JAX module: all
sparse fields share one [F * V, D] table and ids are offset by field, so
one ``embedding_bag`` kernel launch reduces every bag of a batch. The wide
part's scalar gather, the MLP, the candidate GEMV and the top-k stay plain
torch, as they were XLA in the JAX package.

Names and layouts at the public functions are the JAX module's: a batch is
``{"ids": int32 [B, F, NNZ], "id_mask": [B, F, NNZ], "dense": [B,
n_dense]}`` of tensors on the params' device; params are keyed like the
JAX tree (``embed``, ``wide``, ``wide_dense``, ``mlp`` a list of ``{w,
b}``, ``head``, ``bias``, ``candidates``).

On a mesh (``rules``, an :class:`~repro_torch.models.common.AxisRules`
with a ``DeviceMesh``) the functions run on this rank's batch rows and
its pieces of :func:`recsys_param_shardings`: the unified table, the wide
weights and the candidates row-sharded over ``tp``, the MLP replicated. A
rank looks up its row range (:func:`local_rows`: ids outside it masked and
clamped in), runs the ``embedding_bag`` kernel in ``sum`` mode and
``psum``s the bags over ``tp``, dividing by the whole mask's count for
``mean``; retrieval takes each rank's top-k and merges them
(:func:`merge_topk`). The loss's mean is ``psum``med over the batch axes.

Training: :func:`recsys_loss` is the reference's BCE with logits. Where
the table requires a gradient (and grad mode is on) the bags go through
:class:`~repro_torch.kernels.embedding_bag.EmbeddingBag`, whose backward
is the ``embedding_bag_bwd`` kernel; the wide weights' scalar gather, the
MLP and the head take autograd's plain torch gradients, as the reference
leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..kernels.embedding_bag import EmbeddingBag
from ..kernels.embedding_bag import embedding_bag as bag_kernel
from ..launch import collectives as col
from .common import dense_init, normal_init, on_mesh


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int = 40           # categorical fields
    vocab_per_field: int = 1_000_000
    embed_dim: int = 32
    n_dense: int = 13
    nnz_per_field: int = 4       # multi-hot entries per field
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    n_candidates: int = 1_000_000
    retrieval_dim: int = 256

    @property
    def unified_rows(self) -> int:
        return self.n_sparse * self.vocab_per_field

    def param_count(self) -> int:
        emb = self.unified_rows * self.embed_dim
        wide = self.unified_rows + self.n_dense
        d_in = self.n_sparse * self.embed_dim + self.n_dense
        deep = 0
        dims = (d_in,) + self.mlp_dims
        for i in range(len(dims) - 1):
            deep += dims[i] * dims[i + 1] + dims[i + 1]
        retr = self.n_candidates * self.retrieval_dim
        return emb + wide + deep + self.mlp_dims[-1] + 1 + retr


def init_recsys_params(cfg: RecsysConfig, generator: torch.Generator,
                       device: str | torch.device | None = None,
                       dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters in the JAX tree's layout, drawn from
    ``generator`` (a generator on ``device``; ``cuda`` by default), with
    the JAX initialisers' laws: embeddings N(0, 1/embed_dim), wide weights
    N(0, 1e-4), candidates N(0, 1/retrieval_dim), fan-in truncated normals
    for the MLP and head, zero biases."""
    dev = resolve_device(device)
    d_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    dims = (d_in,) + cfg.mlp_dims

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "embed": normal_init(generator, (cfg.unified_rows, cfg.embed_dim),
                             cfg.embed_dim ** -0.5, dtype, dev),
        "wide": normal_init(generator, (cfg.unified_rows,), 0.01, dtype,
                            dev),
        "wide_dense": zeros(cfg.n_dense),
        "mlp": [{"w": dense_init(generator, (dims[i], dims[i + 1]),
                                 dtype=dtype, device=dev),
                 "b": zeros(dims[i + 1])} for i in range(len(dims) - 1)],
        "head": dense_init(generator, (cfg.mlp_dims[-1], 1), dtype=dtype,
                           device=dev),
        "bias": zeros(),
        "candidates": normal_init(generator,
                                  (cfg.n_candidates, cfg.retrieval_dim),
                                  cfg.retrieval_dim ** -0.5, dtype, dev),
    }


def recsys_param_shardings(cfg: RecsysConfig, rules) -> dict:
    """The reference's ``recsys_param_shardings`` as ``{path: spec}``:
    the big tables row-sharded over ``tp``, the MLP (its first dim, 1,293,
    does not tile) replicated."""
    tp = rules.tp
    out = {"embed": (tp, None), "wide": (tp,), "wide_dense": (None,),
           "head": (None, None), "bias": (), "candidates": (tp, None)}
    for i in range(len(cfg.mlp_dims)):
        out[f"mlp/{i}/w"] = (None, None)
        out[f"mlp/{i}/b"] = (None,)
    return out


def _field_ids(ids: torch.Tensor, vocab_per_field: int) -> torch.Tensor:
    """Per-field local ids [B, F, NNZ] -> rows of the unified table."""
    offsets = torch.arange(ids.shape[1], dtype=ids.dtype,
                           device=ids.device) * vocab_per_field
    return ids + offsets[None, :, None]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  vocab_per_field: int, combiner: str = "mean",
                  ) -> torch.Tensor:
    """ids [B, F, NNZ] per-field local ids (int32); mask [B, F, NNZ].

    Returns [B, F, D]: the per-field offset folds all fields into one
    launch of the ``embedding_bag`` kernel; with a gradient to ``table``
    (:class:`EmbeddingBag`) when it requires one."""
    rows = _field_ids(ids, vocab_per_field)
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBag.apply(table, rows, mask, combiner)
    return bag_kernel(table, rows, mask, combiner)


def local_rows(rows: torch.Tensor, mask: torch.Tensor, r0: int, n: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A shard's view of unified-table rows: (ids into its rows [r0, r0 +
    n), clamped into them, and the mask with the rows outside zeroed)."""
    local = rows - r0
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), mask * inside.to(mask.dtype)


def shard_bag(table: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
              r0: int) -> torch.Tensor:
    """One shard's partial bag sums [B, F, D] over its rows of the table
    (``table`` is its [n, D] piece, starting at row ``r0``): the
    ``embedding_bag`` kernel in ``sum`` mode on :func:`local_rows`."""
    local, m = local_rows(rows, mask, r0, table.shape[0])
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBag.apply(table, local, m, "sum")
    return bag_kernel(table, local, m, "sum")


def _bags(cfg: RecsysConfig, params: dict, batch: dict, rules=None
          ) -> torch.Tensor:
    """The field bags [B, F, D] (mean over each bag); on a mesh the ranks'
    partial sums (:func:`shard_bag`) ``psum``med over ``tp`` and divided
    by the whole mask's count."""
    ids, mask = batch["ids"], batch["id_mask"]
    if not on_mesh(rules):
        return embedding_bag(params["embed"], ids, mask,
                             cfg.vocab_per_field)
    table = params["embed"]
    r0 = col.axis_index(rules.mesh, rules.tp) * table.shape[0]
    s = col.psum(shard_bag(table, _field_ids(ids, cfg.vocab_per_field), mask,
                           r0), rules.mesh, rules.tp)
    count = mask.to(s.dtype).sum(dim=2).clamp(min=1.0)
    return s / count[..., None]


def _deep_input(cfg: RecsysConfig, params: dict, batch: dict,
                rules=None) -> torch.Tensor:
    """concat(field bags, dense): the MLP's input [B, F * D + n_dense]."""
    ids, dense = batch["ids"], batch["dense"]
    bags = _bags(cfg, params, batch, rules)
    return torch.cat([bags.reshape(ids.shape[0], -1),
                      dense.to(bags.dtype)], dim=-1)


def _mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    for layer in params["mlp"]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x


def wide_deep_logits(cfg: RecsysConfig, params: dict, batch: dict,
                     rules=None) -> torch.Tensor:
    """batch: ids [B,F,NNZ] int32, id_mask [B,F,NNZ], dense [B, n_dense]
    -> logits [B]. On a mesh the wide weights' bag sums are the ranks'
    partial sums over their rows, ``psum``med over ``tp``."""
    ids, mask, dense = batch["ids"], batch["id_mask"], batch["dense"]
    # wide: per-id scalar weights, bag-summed + dense linear
    rows = _field_ids(ids, cfg.vocab_per_field)
    if not on_mesh(rules):
        wide_vals = params["wide"][rows]
        wide = (wide_vals * mask.to(wide_vals.dtype)).sum(dim=(1, 2))
    else:
        n = params["wide"].shape[0]
        local, m = local_rows(rows, mask, col.axis_index(
            rules.mesh, rules.tp) * n, n)
        wide_vals = params["wide"][local]
        wide = col.psum((wide_vals * m.to(wide_vals.dtype)).sum(dim=(1, 2)),
                        rules.mesh, rules.tp)
    wide = wide + dense.to(wide_vals.dtype) @ params["wide_dense"]
    # deep: concat(field bags, dense) -> MLP (interaction=concat)
    deep = (_mlp(params, _deep_input(cfg, params, batch, rules))
            @ params["head"])[:, 0]
    return wide + deep + params["bias"]


def recsys_loss(cfg: RecsysConfig, params: dict, batch: dict,
                rules=None) -> tuple[torch.Tensor, dict]:
    """Binary cross-entropy with logits against ``batch["labels"]`` [B]
    (the reference's ``recsys_loss``): ``mean(max(z, 0) - z y + log1p(
    exp(-|z|)))`` on float32 logits z, and the accuracy of ``z > 0``
    against ``y > 0.5``. Returns (loss, {"bce", "acc"}). On a mesh with
    batch axes the batch is this rank's rows: both sums are ``psum``med
    over the batch axes and divided by every rank's count, so each rank
    returns the whole loss and its share of each gradient."""
    logits = wide_deep_logits(cfg, params, batch, rules).float()
    y = batch["labels"].float()
    terms = (torch.clamp(logits, min=0) - logits * y
             + torch.log1p(torch.exp(-logits.abs())))
    hits = ((logits > 0) == (y > 0.5)).float()
    if on_mesh(rules) and rules.batch:
        n = y.numel() * col.axis_size(rules.mesh, rules.batch)
        loss = col.psum(terms.sum(), rules.mesh, rules.batch) / n
        acc = col.psum(hits.sum(), rules.mesh, rules.batch) / n
    else:
        loss, acc = torch.mean(terms), hits.mean()
    return loss, {"bce": loss, "acc": acc}


def recsys_score(cfg: RecsysConfig, params: dict, batch: dict,
                 rules=None) -> torch.Tensor:
    """Online/offline scoring path (serve_p99 / serve_bulk): sigmoid of
    the logits, [B]."""
    return torch.sigmoid(wide_deep_logits(cfg, params, batch, rules))


def merge_topk(values: torch.Tensor, indices: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best of several shards' top-k lists, [B, n] values and global
    indices side by side: best first, a tie going to the lower index (as
    ``lax.top_k``): a stable sort by index, then a stable descending sort
    by value."""
    order = torch.sort(indices, dim=-1, stable=True).indices
    values, indices = values.gather(-1, order), indices.gather(-1, order)
    order = torch.sort(values, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return values.gather(-1, order), indices.gather(-1, order)


def retrieval_topk(cfg: RecsysConfig, params: dict, batch: dict,
                   k: int = 100, rules=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score each query's user tower (the last MLP layer, retrieval_dim)
    against every candidate; the k best as (scores [B, k], indices [B, k]),
    best first, as ``jax.lax.top_k`` gives them. On a mesh each rank
    scores its candidate rows and takes their top-k; the values and
    global indices are all-gathered over ``tp`` and merged
    (:func:`merge_topk`)."""
    x = _mlp(params, _deep_input(cfg, params, batch, rules))
    scores = x @ params["candidates"].T               # [B, n_candidates]
    if not on_mesh(rules):
        return torch.topk(scores, k, dim=-1)
    vals, idx = torch.topk(scores, min(k, scores.shape[-1]), dim=-1)
    idx = idx + col.axis_index(rules.mesh, rules.tp) * scores.shape[-1]
    return merge_topk(col.all_gather(vals, rules.mesh, rules.tp, dim=-1),
                      col.all_gather(idx, rules.mesh, rules.tp, dim=-1), k)
