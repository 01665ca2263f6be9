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
b}``, ``head``, ``bias``, ``candidates``). Where the port differs, by
design: there is no sharding (``AxisRules``), as it serves from one card;
``recsys_loss`` and training are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..kernels.embedding_bag import embedding_bag as bag_kernel
from .common import dense_init, normal_init


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
    launch of the ``embedding_bag`` kernel."""
    return bag_kernel(table, _field_ids(ids, vocab_per_field), mask,
                      combiner)


def _deep_input(cfg: RecsysConfig, params: dict, batch: dict
                ) -> torch.Tensor:
    """concat(field bags, dense): the MLP's input [B, F * D + n_dense]."""
    ids, dense = batch["ids"], batch["dense"]
    bags = embedding_bag(params["embed"], ids, batch["id_mask"],
                         cfg.vocab_per_field)
    return torch.cat([bags.reshape(ids.shape[0], -1),
                      dense.to(bags.dtype)], dim=-1)


def _mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    for layer in params["mlp"]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x


def wide_deep_logits(cfg: RecsysConfig, params: dict, batch: dict
                     ) -> torch.Tensor:
    """batch: ids [B,F,NNZ] int32, id_mask [B,F,NNZ], dense [B, n_dense]
    -> logits [B]."""
    ids, mask, dense = batch["ids"], batch["id_mask"], batch["dense"]
    # wide: per-id scalar weights, bag-summed + dense linear
    wide_vals = params["wide"][_field_ids(ids, cfg.vocab_per_field)]
    wide = (wide_vals * mask.to(wide_vals.dtype)).sum(dim=(1, 2))
    wide = wide + dense.to(wide_vals.dtype) @ params["wide_dense"]
    # deep: concat(field bags, dense) -> MLP (interaction=concat)
    deep = (_mlp(params, _deep_input(cfg, params, batch))
            @ params["head"])[:, 0]
    return wide + deep + params["bias"]


def recsys_score(cfg: RecsysConfig, params: dict, batch: dict
                 ) -> torch.Tensor:
    """Online/offline scoring path (serve_p99 / serve_bulk): sigmoid of
    the logits, [B]."""
    return torch.sigmoid(wide_deep_logits(cfg, params, batch))


def retrieval_topk(cfg: RecsysConfig, params: dict, batch: dict,
                   k: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Score each query's user tower (the last MLP layer, retrieval_dim)
    against every candidate; the k best as (scores [B, k], indices [B, k]),
    best first, as ``jax.lax.top_k`` gives them."""
    x = _mlp(params, _deep_input(cfg, params, batch))
    scores = x @ params["candidates"].T               # [B, n_candidates]
    return torch.topk(scores, k, dim=-1)
