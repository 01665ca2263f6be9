"""repro_torch: cloud-edge collaborative SPARQL over large RDF graphs, in
PyTorch with hand-written CUDA kernels for the H100.

The port of :mod:`repro` (the JAX package, kept as the reference). It
imports nothing of ``repro`` and nothing of JAX: the framework-neutral
modules it needs are its own copies, and the device layer is torch.

Layers (ported so far: the SPARQL read and write paths, the paper's
cloud-edge system with B&B on the R-QAD bound, the serving front end, the
workload harness, the dense LM serving path, Wide&Deep scoring and
retrieval, GCN inference)
-----------------------------------------------------------------------
- ``repro_torch.rdf``     : dictionary-encoded triple store + generators
- ``repro_torch.sparql``  : parser, algebra, matcher, batched engine with
  the ``torch`` backend and the device-resident join, SPARQL UPDATE
  compilation, partial evaluation across edges, ``SparqlEndpoint``
- ``repro_torch.core``    : query patterns and their index, pattern-induced
  subgraphs, placement, the cost model, CRA, the R-QAD relaxation, B&B and
  the baselines
- ``repro_torch.runtime`` : the offload serving pool, micro-batch admission,
  the SPARQL-protocol HTTP server
- ``repro_torch.workload``: witnessed query sampling, traffic schedules,
  replay with verification
- ``repro_torch.edge``    : edge and cloud servers, rebalancing, and
  ``EdgeCloudSystem`` (history -> placement -> schedule -> execution)
- ``repro_torch.models``  : dense decoder LM (prefill, KV-cache decode),
  Wide&Deep (scoring, retrieval), GCN (forward over sorted edges)
- ``repro_torch.data``    : synthetic recsys batches and graphs
- ``repro_torch.configs`` : qwen3-0.6b, qwen3-1.7b, gemma2-2b, wide-deep,
  gcn-cora; LM, recsys and GNN shapes
- ``repro_torch.kernels`` : CUDA kernels (``csrc/rdf_kernels.cu``,
  ``csrc/attention_kernels.cu``, ``csrc/flash_tc.cu``, ``csrc/decode_tc.cu``,
  ``csrc/sparse_kernels.cu``, ``csrc/qad_kernels.cu``) and their plain
  torch versions
- ``repro_torch.convert`` : carries a reference store + dictionary, the
  system's ``SystemParams``, or a reference LM, Wide&Deep or GCN parameter
  tree, over

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
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target[0]), target[1])


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
