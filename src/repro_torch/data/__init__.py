"""Synthetic datasets of the recsys and GNN serving paths (numpy copies of
``repro/data``'s generators, plus a power-law graph drawn on the device)."""
