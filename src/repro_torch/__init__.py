"""repro_torch: cloud-edge collaborative SPARQL over large RDF graphs, in
PyTorch with hand-written CUDA kernels for the H100.

The port of :mod:`repro` (the JAX package, kept as the reference). It
imports nothing of ``repro`` and nothing of JAX: the framework-neutral
modules it needs are its own copies, and the device layer is torch.

Layers (this slice: the SPARQL read path)
-----------------------------------------
- ``repro_torch.rdf``     : dictionary-encoded triple store + generators
- ``repro_torch.sparql``  : parser, algebra, matcher, batched engine with
  the ``torch`` backend and the device-resident join, ``SparqlEndpoint``
- ``repro_torch.kernels`` : CUDA kernels (``csrc/rdf_kernels.cu``) and
  their plain torch versions
- ``repro_torch.convert`` : carries a reference store + dictionary over

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
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target[0]), target[1])


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
