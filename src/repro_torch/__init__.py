"""repro_torch: cloud-edge collaborative SPARQL over large RDF graphs, in
PyTorch with hand-written CUDA kernels for the H100.

The port of :mod:`repro` (the JAX package, kept as the reference). It
imports nothing of ``repro`` and nothing of JAX: the framework-neutral
modules it needs are its own copies, and the device layer is torch.

Layers (ported so far: the SPARQL read and write paths, the paper's
cloud-edge system with B&B on the R-QAD bound, the serving front end, the
workload harness, the dense and MoE LM serving paths, Wide&Deep scoring
and retrieval, GCN, PNA, EGNN and NequIP inference, LM and Wide&Deep
training)
-----------------------------------------------------------------------
- ``repro_torch.rdf``     : dictionary-encoded triple store + generators
- ``repro_torch.sparql``  : parser, algebra, matcher, batched engine with
  the ``torch`` backend and the device-resident join, SPARQL UPDATE
  compilation, partial evaluation across edges, ``SparqlEndpoint``
- ``repro_torch.core``    : query patterns and their index, pattern-induced
  subgraphs, placement, the cost model, CRA, the R-QAD relaxation, B&B and
  the baselines
- ``repro_torch.runtime`` : the offload serving pool, micro-batch admission,
  the SPARQL-protocol HTTP server; the train loop, checkpoints, fault
  tolerance
- ``repro_torch.optim``   : AdamW (float32 moments) and int8 error-feedback
  compression
- ``repro_torch.launch``  : the training driver (``python -m
  repro_torch.launch.train``)
- ``repro_torch.workload``: witnessed query sampling, traffic schedules,
  replay with verification
- ``repro_torch.edge``    : edge and cloud servers, rebalancing, and
  ``EdgeCloudSystem`` (history -> placement -> schedule -> execution)
- ``repro_torch.models``  : dense decoder LM (prefill, KV-cache decode,
  ``lm_loss``), Wide&Deep (scoring, retrieval, ``recsys_loss``), GCN, PNA,
  EGNN and NequIP (forwards over sorted edges, chunked at node
  boundaries; energies)
- ``repro_torch.data``    : synthetic recsys batches and graphs
- ``repro_torch.configs`` : the reference's ten archs (dense and MoE LMs,
  PNA, EGNN, GCN, NequIP, Wide&Deep); LM, recsys and GNN shapes
- ``repro_torch.kernels`` : CUDA kernels (``csrc/rdf_kernels.cu``,
  ``csrc/attention_kernels.cu``, ``csrc/flash_tc.cu``, ``csrc/decode_tc.cu``,
  ``csrc/flash_bwd.cu``, ``csrc/sparse_kernels.cu``,
  ``csrc/qad_kernels.cu``), the autograd Functions of the training path
  and their plain torch versions
- ``repro_torch.convert`` : carries a reference store + dictionary, the
  system's ``SystemParams``, a reference LM, Wide&Deep or GNN parameter
  tree, or an AdamW state, over

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

_LAZY = {
    "SparqlEndpoint": ("repro_torch.sparql.endpoint", "SparqlEndpoint"),
    "QueryEngine": ("repro_torch.sparql.engine", "QueryEngine"),
    "TorchBackend": ("repro_torch.sparql.engine", "TorchBackend"),
    "SolutionTable": ("repro_torch.sparql.algebra", "SolutionTable"),
    "compile_query": ("repro_torch.sparql.algebra", "compile_query"),
    "parse_query": ("repro_torch.sparql.query", "parse_query"),
    "parse_sparql": ("repro_torch.sparql.query", "parse_sparql"),
    "from_reference": ("repro_torch.convert", "from_reference"),
    "system_params_from_reference": ("repro_torch.convert",
                                     "system_params_from_reference"),
    "EdgeCloudSystem": ("repro_torch.edge.system", "EdgeCloudSystem"),
    "SystemParams": ("repro_torch.core.cost", "SystemParams"),
    "lm_params_from_reference": ("repro_torch.convert",
                                 "lm_params_from_reference"),
    "LMConfig": ("repro_torch.models.transformer", "LMConfig"),
    "init_lm_params": ("repro_torch.models.transformer", "init_lm_params"),
    "init_kv_cache": ("repro_torch.models.transformer", "init_kv_cache"),
    "lm_forward": ("repro_torch.models.transformer", "lm_forward"),
    "lm_prefill": ("repro_torch.models.transformer", "lm_prefill"),
    "lm_decode_step": ("repro_torch.models.transformer", "lm_decode_step"),
    "get_spec": ("repro_torch.configs.registry", "get_spec"),
    "flash_attention": ("repro_torch.kernels.flash_attention",
                        "flash_attention"),
    "decode_attention": ("repro_torch.kernels.decode_attention",
                         "decode_attention"),
    "recsys_params_from_reference": ("repro_torch.convert",
                                     "recsys_params_from_reference"),
    "gnn_params_from_reference": ("repro_torch.convert",
                                  "gnn_params_from_reference"),
    "RecsysConfig": ("repro_torch.models.recsys", "RecsysConfig"),
    "init_recsys_params": ("repro_torch.models.recsys",
                           "init_recsys_params"),
    "wide_deep_logits": ("repro_torch.models.recsys", "wide_deep_logits"),
    "recsys_score": ("repro_torch.models.recsys", "recsys_score"),
    "retrieval_topk": ("repro_torch.models.recsys", "retrieval_topk"),
    "GNNConfig": ("repro_torch.models.gnn", "GNNConfig"),
    "gcn_init": ("repro_torch.models.gnn", "gcn_init"),
    "gcn_forward": ("repro_torch.models.gnn", "gcn_forward"),
    "gnn_init": ("repro_torch.models.gnn", "gnn_init"),
    "pna_forward": ("repro_torch.models.gnn", "pna_forward"),
    "egnn_forward": ("repro_torch.models.gnn", "egnn_forward"),
    "egnn_energy": ("repro_torch.models.gnn", "egnn_energy"),
    "nequip_forward": ("repro_torch.models.gnn", "nequip_forward"),
    "nequip_energy": ("repro_torch.models.gnn", "nequip_energy"),
    "sort_by_dst": ("repro_torch.models.gnn", "sort_by_dst"),
    "segment_sum_sorted": ("repro_torch.kernels.segment_mp",
                           "segment_sum_sorted"),
    "embedding_bag": ("repro_torch.kernels.embedding_bag", "embedding_bag"),
    "branch_and_bound": ("repro_torch.core.bnb", "branch_and_bound"),
    "solve_rqad": ("repro_torch.core.qad", "solve_rqad"),
    "solve_rqad_batch": ("repro_torch.core.qad", "solve_rqad_batch"),
    "qad_solve": ("repro_torch.kernels.qad_solve", "qad_solve"),
    "OffloadServingPool": ("repro_torch.runtime.serving",
                           "OffloadServingPool"),
    "Replica": ("repro_torch.runtime.serving", "Replica"),
    "make_sparql_runner": ("repro_torch.runtime.serving",
                           "make_sparql_runner"),
    "AdmissionQueue": ("repro_torch.runtime.admission", "AdmissionQueue"),
    "SparqlHttpServer": ("repro_torch.runtime.http", "SparqlHttpServer"),
    "PatternSampler": ("repro_torch.workload.sampler", "PatternSampler"),
    "ShapeConfig": ("repro_torch.workload.sampler", "ShapeConfig"),
    "TrafficConfig": ("repro_torch.workload.traffic", "TrafficConfig"),
    "build_schedule": ("repro_torch.workload.traffic", "build_schedule"),
    "replay": ("repro_torch.workload.driver", "replay"),
    "lm_loss": ("repro_torch.models.transformer", "lm_loss"),
    "recsys_loss": ("repro_torch.models.recsys", "recsys_loss"),
    "AdamWConfig": ("repro_torch.optim.adamw", "AdamWConfig"),
    "TrainLoopConfig": ("repro_torch.runtime.train_loop", "TrainLoopConfig"),
    "train": ("repro_torch.runtime.train_loop", "train"),
    "save_checkpoint": ("repro_torch.runtime.checkpoint", "save_checkpoint"),
    "restore_checkpoint": ("repro_torch.runtime.checkpoint",
                           "restore_checkpoint"),
    "adamw_state_from_reference": ("repro_torch.convert",
                                   "adamw_state_from_reference"),
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target[0]), target[1])


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
