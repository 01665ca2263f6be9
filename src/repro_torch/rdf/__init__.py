"""Dictionary-encoded RDF storage, sharding, deltas and generators (copies
of the JAX package's framework-neutral ``repro.rdf`` modules)."""
