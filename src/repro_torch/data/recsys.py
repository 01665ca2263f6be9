"""Synthetic recsys batches with a planted logistic structure (copy of
``repro/data/recsys.py``, numpy only).

Labels come from a sparse ground-truth weight vector over (field, id) pairs
so training measurably reduces BCE — not pure noise.
"""

from __future__ import annotations

import numpy as np


def recsys_batch(batch: int, n_sparse: int = 40, vocab: int = 1_000_000,
                 nnz: int = 4, n_dense: int = 13, seed: int = 0,
                 hot_fraction: float = 0.05) -> dict:
    """Power-law ids + dense features + planted-model labels."""
    rng = np.random.default_rng(seed)
    # power-law id popularity within each field
    u = rng.random((batch, n_sparse, nnz))
    ids = np.minimum((vocab * u ** 3).astype(np.int64), vocab - 1)
    mask = (rng.random((batch, n_sparse, nnz)) < 0.85).astype(np.float32)
    mask[..., 0] = 1.0  # at least one id per bag
    dense = rng.normal(0, 1, (batch, n_dense)).astype(np.float32)
    # planted model: "hot" ids (small id values) push labels positive
    hot = (ids < vocab * hot_fraction).astype(np.float32) * mask
    logit = hot.sum(axis=(1, 2)) * 0.8 - 2.0 + dense[:, 0] * 0.5
    labels = (rng.random(batch) < 1.0 / (1.0 + np.exp(-logit))
              ).astype(np.float32)
    return {"ids": ids.astype(np.int32), "id_mask": mask, "dense": dense,
            "labels": labels}
