"""Carry the reference system's state over to the port.

The system has no weights: its state is the triple store and the term
dictionary. :func:`from_reference` takes the numpy dicts the JAX package's
``TripleStore.to_arrays()`` / ``ShardedTripleStore.to_arrays()`` and
``Dictionary.to_arrays()`` produce and rebuilds them as the port's store
and dictionary. It reads plain arrays only, so it imports nothing of the
JAX package.
"""

from __future__ import annotations

import numpy as np

from .rdf.dictionary import Dictionary
from .rdf.graph import TripleStore
from .rdf.sharding import ShardedTripleStore


def from_reference(store_arrays: dict[str, np.ndarray],
                   dict_arrays: dict[str, np.ndarray],
                   num_shards: int | None = None):
    """``(store, dictionary)`` of the port from the reference's arrays.

    ``store_arrays`` holds ``s``, ``p``, ``o`` and ``meta``
    (``[num_entities, num_predicates]``, plus ``num_shards`` for a sharded
    store). ``num_shards`` re-partitions the store; by default a sharded
    store keeps its shard count and a monolithic one stays monolithic.
    Term ids are preserved, so both sides answer with the same ids.
    """
    meta = [int(x) for x in store_arrays["meta"]]
    if num_shards is None and len(meta) > 2:
        num_shards = meta[2]
    s, p, o = store_arrays["s"], store_arrays["p"], store_arrays["o"]
    if num_shards is None:
        store = TripleStore(s, p, o, meta[0], meta[1])
    else:
        store = ShardedTripleStore(s, p, o, meta[0], meta[1],
                                   num_shards=int(num_shards))
    return store, Dictionary.from_arrays(dict_arrays)
