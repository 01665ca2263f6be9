"""SPARQL parser, algebra, matcher, batched engine and endpoint."""
