"""The serving front end: the offload serving pool (the paper's scheduler
placing requests across replicas), micro-batch admission, and the
SPARQL-protocol HTTP server over a :class:`~repro_torch.SparqlEndpoint`;
and the training runtime: the train loop, checkpoints and fault
tolerance."""
