"""Int8 error-feedback gradient compression (port of
``repro/optim/compression.py``).

Quantize (grad + residual) to int8 with a per-tensor scale, keep the
quantization error as the residual for the next step (EF-SGD). The
reference's ``compressed_psum`` (an all-reduce inside ``shard_map``)
waits for the port's ``launch/mesh.py`` (ROADMAP Queue 1 item 8).
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

from .. import tree


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grad: torch.Tensor, residual: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one tensor.

    Returns (q_int8, scale, new_residual)."""
    g = grad.float() + residual
    q, scale = quantize_int8(g)
    return q, scale, g - dequantize_int8(q, scale)


def ef_compress_tree(grads, residuals):
    """Tree version. Returns (quantized tree, scales tree, residual
    tree)."""
    out = [ef_compress(g, r) for g, r in zip(tree.leaves(grads),
                                             tree.leaves(residuals))]
    return tuple(tree.unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def ef_decompress_tree(qtree, stree):
    return tree.tree_map(dequantize_int8, qtree, stree)


def init_residuals(params):
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
