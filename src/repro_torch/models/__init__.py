"""The serving paths of the model zoo, in PyTorch (port of
``repro.models``: ``common``, the dense path of ``transformer``, the
scoring and retrieval path of ``recsys`` and the GCN, PNA, EGNN and NequIP
inference of ``gnn``)."""
