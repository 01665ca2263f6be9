"""Architecture registry (port of ``repro/configs/registry.py``): 10
archs x their shape grids, and the *cells* built from them.

Each arch module exposes ``spec() -> ArchSpec``. The port serves all ten
of the reference's archs: the dense and MoE LMs (qwen3, gemma2,
granite-moe, phi3.5-moe), the GNNs (PNA, EGNN, GCN, NequIP) and
Wide&Deep. A cell is an (arch x shape) unit: the port's step function and
its abstract arguments, tensors on the ``meta`` device (shapes and
dtypes, no storage) in the reference's tree order, consumed by the dry
run (:mod:`repro_torch.launch.dryrun`) and by ``chip_smoke.py``'s cells
phase, which makes real arguments of the same shapes.

On a mesh (:mod:`repro_torch.launch.mesh`, or a ``MetaMesh`` in the dry
run), :func:`build_cell` builds every cell as the reference's does: the
step runs on ``AxisRules.for_mesh(mesh)``, and the cell's ``in_specs``
give each argument's layout, the reference's ``in_shardings`` as tuples
of axis names, ``{path: spec}`` per argument (a bare tensor's path is
``""``): for the GNNs node and edge arrays over the batch axes where
their leading dim divides, ``energy`` and the params replicated; for the
LMs ``param_shardings`` (FSDP and TP of every weight), the AdamW moments
as the params, tokens over the batch axes where the batch divides
(``(None, batch)`` for microbatches), the cache by ``cache_shardings``
and ``pos`` replicated; for Wide&Deep ``recsys_param_shardings`` (the
tables row-sharded over ``tp``) and the batch leaves over the batch axes
where they divide (``labels`` always). Each rank passes its pieces
(``convert.local_shard``). A mesh decode cell's ``pos`` is an int (the
sharded decode cuts each rank's slice on the host), ``S - 1`` in its
``abstract_args``: every position visible. A
:class:`Cell` has no ``probe``: the reference's single-layer probe
corrects XLA's cost analysis, which counts a scan body once
(``repro/launch/dryrun.py``); the port runs eagerly, and its counters see
every layer.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..launch.collectives import axis_size
from ..models.common import AxisRules
from ..models.gnn import GNNConfig, gnn_init, gnn_loss
from ..models.recsys import (RecsysConfig, init_recsys_params, recsys_loss,
                             recsys_param_shardings, recsys_score,
                             retrieval_topk)
from ..models.transformer import (LMConfig, cache_shardings, init_kv_cache,
                                  init_lm_params, lm_decode_step, lm_forward,
                                  lm_loss, param_shardings)
from ..optim.adamw import AdamWConfig, adamw_init
from ..runtime.train_loop import make_train_step

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
    microbatches: int = 1            # grad-accumulation factor for train cells

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


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for a in ARCH_IDS:
        s = get_spec(a)
        cells.extend((a, shape) for shape in s.shapes)
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for a in ARCH_IDS:
        s = get_spec(a)
        out.extend((a, shape, why) for shape, why in s.skip_shapes.items())
    return out


# ---------------------------------------------------------------------------
# cell construction (the dry run and the chip script's cells phase)
# ---------------------------------------------------------------------------

META = torch.device("meta")


@dataclass
class Cell:
    fn: Callable                # the port's step
    abstract_args: tuple        # meta tensors (params, opt, batch, ...)
    description: str = ""
    # grad-accumulation factor (== microbatches), as the reference's
    # roofline totals scale by it
    cost_multiplier: int = 1
    # on a mesh, each argument's layout: {path: spec} per argument
    # (``convert.local_shard``'s), paths left out replicated
    in_specs: tuple = ()


def _pad_to(n: int, m: int = 512) -> int:
    """The reference pipeline's padding: leading dims divisible by the
    batch-axis product of its meshes (the shapes stay the reference's)."""
    return ((n + m - 1) // m) * m


def _opt_cfg() -> AdamWConfig:
    return AdamWConfig(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_dim_spec(mesh, rules: AxisRules, dim: int):
    """The reference's ``_batch_dim_spec``: the batch axes where ``dim``
    divides by their ranks, else ``None`` (whole)."""
    return rules.batch if dim % axis_size(mesh, rules.batch) == 0 else None


def _opt_specs(p_specs: dict) -> dict:
    """The AdamW state's layouts: the moments as the params, ``step``
    replicated."""
    return {f"{m}/{k}": v for m in ("m", "v") for k, v in p_specs.items()}


def build_cell(spec: ArchSpec, shape_name: str, mesh=None) -> Cell:
    """The cell of ``spec`` at ``shape_name``. ``mesh``: ``None`` or a
    :mod:`repro_torch.launch.mesh` mesh (a ``DeviceMesh`` or a
    ``MetaMesh``): the cell then runs on the mesh routes and states its
    ``in_specs``."""
    rules = None if mesh is None else AxisRules.for_mesh(mesh)
    if spec.family == "gnn":
        return _gnn_cell(spec, shape_name, mesh)
    if spec.family == "lm":
        return _lm_cell(spec, shape_name, mesh, rules)
    return _recsys_cell(spec, shape_name, mesh, rules)


# -- LM ----------------------------------------------------------------------

def _lm_cell(spec: ArchSpec, shape_name: str, mesh=None,
             rules: AxisRules | None = None) -> Cell:
    cfg: LMConfig = spec.config
    sh = LM_SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    params = init_lm_params(cfg, torch.Generator(), device=META)
    p_specs = param_shardings(cfg, rules) if mesh is not None else {}

    def tokens_spec(dim: int, lead: tuple = ()) -> dict:
        if mesh is None:
            return {}
        ax = _batch_dim_spec(mesh, rules, dim)
        return {"": (*lead, ax)} if ax else {}

    if sh["kind"] == "train":
        mb = spec.microbatches
        step = make_train_step(lambda p, t: lm_loss(cfg, p, t, rules),
                               _opt_cfg(), microbatches=mb, rules=rules,
                               specs=p_specs)
        tokens = _meta((mb, B // mb, S) if mb > 1 else (B, S), torch.int32)
        specs = ()
        if mesh is not None:
            specs = (p_specs, _opt_specs(p_specs),
                     tokens_spec(B // mb, (None,)) if mb > 1
                     else tokens_spec(B))
        return Cell(fn=step, abstract_args=(params, adamw_init(params),
                                            tokens),
                    description=f"train_step B={B} S={S} mb={mb}",
                    cost_multiplier=mb, in_specs=specs)

    if sh["kind"] == "prefill":
        def fwd(params, tokens):
            return lm_forward(cfg, params, tokens, rules)[0]
        return Cell(fn=fwd, abstract_args=(params, _meta((B, S),
                                                         torch.int32)),
                    description=f"prefill B={B} S={S}",
                    in_specs=(p_specs, tokens_spec(B))
                    if mesh is not None else ())

    seq_shard = sh.get("seq_shard", False)

    def decode(params, cache, tokens, pos):
        return lm_decode_step(cfg, params, cache, tokens, pos, rules,
                              seq_shard)

    cache = init_kv_cache(cfg, B, S, device=META)
    pos = _meta((), torch.int32) if mesh is None else S - 1
    return Cell(fn=decode,
                abstract_args=(params, cache, _meta((B, 1), torch.int32),
                               pos),
                description=f"serve_step B={B} cache={S}",
                in_specs=(p_specs, cache_shardings(cfg, rules, seq_shard),
                          tokens_spec(B), {}) if mesh is not None else ())


# -- GNN ----------------------------------------------------------------------

def _gnn_batch_struct(cfg: GNNConfig, sh: dict) -> dict:
    """The batch of a GNN cell, meta tensors with the reference's keys."""
    if sh["kind"] == "molecule":
        N = sh["n_graphs"] * sh["nodes_per"]
        E = sh["n_graphs"] * sh["edges_per"]
        G = sh["n_graphs"]
    else:
        N, E, G = sh["n_nodes"], sh["n_edges"], 1
    N, E = _pad_to(N), _pad_to(E)   # pipeline pads to shardable sizes
    ei = _meta((E, 2), torch.int32)
    if cfg.model in ("gcn", "pna"):
        d_feat = sh.get("d_feat", cfg.d_feat)
        return {
            "feat": _meta((N, d_feat), torch.float32),
            "edge_index": ei,
            "labels": _meta((N,), torch.int32),
            "label_mask": _meta((N,), torch.float32),
        }
    return {
        "species": _meta((N,), torch.int32),
        "coords": _meta((N, 3), torch.float32),
        "edge_index": ei,
        "graph_ids": _meta((N,), torch.int32),
        "energy": _meta((G,), torch.float32),
    }


def gnn_cell_config(cfg: GNNConfig, shape_name: str) -> tuple[GNNConfig,
                                                              dict]:
    """(the config a GNN cell trains, its shape): GCN and PNA take the
    shape's d_feat (one-hot species at the molecule shape)."""
    sh = dict(GNN_SHAPES[shape_name])
    if cfg.model in ("gcn", "pna") and sh["kind"] == "molecule":
        sh["d_feat"] = cfg.n_species      # one-hot species as features
    if cfg.model in ("gcn", "pna"):
        cfg = dataclasses.replace(cfg, d_feat=sh.get("d_feat", cfg.d_feat))
    return cfg, sh


def gnn_batch_specs(batch: dict, mesh, rules: AxisRules) -> dict:
    """The reference's layouts of a GNN batch (``_gnn_cell``): each leaf
    but ``energy`` over the batch axes where its leading dim divides by
    their ranks (``_batch_dim_spec``), else whole."""
    shards = axis_size(mesh, rules.batch)
    return {k: (rules.batch,) for k, v in batch.items()
            if k != "energy" and v.shape[0] % shards == 0}


def _gnn_cell(spec: ArchSpec, shape_name: str, mesh=None) -> Cell:
    dcfg, sh = gnn_cell_config(spec.config, shape_name)
    params = gnn_init(dcfg, torch.Generator(), device=META)
    batch = _gnn_batch_struct(dcfg, sh)
    # vertex-partitioned DistGNN schedule on a mesh: node and edge arrays
    # over the batch axes, the params (tiny) replicated
    rules = None if mesh is None else AxisRules.for_mesh(mesh)
    step = make_train_step(lambda p, b: gnn_loss(dcfg, p, b, rules),
                           _opt_cfg(), rules=rules)
    specs = ()
    if mesh is not None:
        specs = ({}, {}, gnn_batch_specs(batch, mesh, rules))
        if len(specs[2]) != len(batch) - ("energy" in batch):
            raise ValueError(f"gnn cell {shape_name}: the mesh routes take "
                             f"every node and edge array sharded; a leading "
                             f"dim does not divide by the batch axes' "
                             f"ranks")
    return Cell(fn=step, abstract_args=(params, adamw_init(params), batch),
                description=f"gnn train {shape_name}", in_specs=specs)


# -- recsys ------------------------------------------------------------------

def _recsys_cell(spec: ArchSpec, shape_name: str, mesh=None,
                 rules: AxisRules | None = None) -> Cell:
    cfg: RecsysConfig = spec.config
    sh = RECSYS_SHAPES[shape_name]
    B = sh["batch"]
    params = init_recsys_params(cfg, torch.Generator(), device=META)
    bag = (B, cfg.n_sparse, cfg.nnz_per_field)
    batch = {"ids": _meta(bag, torch.int32),
             "id_mask": _meta(bag, torch.float32),
             "dense": _meta((B, cfg.n_dense), torch.float32)}
    p_specs, b_specs = {}, {}
    if mesh is not None:
        p_specs = recsys_param_shardings(cfg, rules)
        ax = _batch_dim_spec(mesh, rules, B)
        if ax:
            b_specs = {"ids": (ax,), "id_mask": (ax,), "dense": (ax,)}
    if sh["kind"] == "train":
        batch["labels"] = _meta((B,), torch.float32)
        if mesh is not None:
            b_specs["labels"] = (rules.batch,)
        step = make_train_step(lambda p, b: recsys_loss(cfg, p, b, rules),
                               _opt_cfg(), rules=rules, specs=p_specs)
        return Cell(fn=step, abstract_args=(params, adamw_init(params),
                                            batch),
                    description=f"recsys train B={B}",
                    in_specs=(p_specs, _opt_specs(p_specs), b_specs)
                    if mesh is not None else ())
    specs = (p_specs, b_specs) if mesh is not None else ()
    if sh["kind"] == "score":
        def fn(params, batch):
            return recsys_score(cfg, params, batch, rules)
        return Cell(fn=fn, abstract_args=(params, batch),
                    description=f"recsys score B={B}", in_specs=specs)

    def fn(params, batch):
        return retrieval_topk(cfg, params, batch, k=100, rules=rules)
    return Cell(fn=fn, abstract_args=(params, batch),
                description=f"retrieval B={B} C={cfg.n_candidates}",
                in_specs=specs)
